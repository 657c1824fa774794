"""The port's expert-TP MoE path (``moe_ffn_local`` on a ``VirtualMesh``)
against JAX's shard_map path on the conftest's host mesh.

Reduced deepseek-moe-16b and mixtral-8x22b in f32, weights carried
across through numpy (``repro_torch.bridge``), inputs made by numpy from
a seed.  JAX runs ``moe_ffn_local`` under ``shard_map`` on a
``jax.make_mesh`` of the same (data, model) shape; the port runs its
virtual ranks on one device.  Held:

  * y and the aux loss within 1e-5 on meshes (1, 2), (1, 4), (2, 2) and
    (2, 4), with and without ``moe_fsdp``; with capacity factor 1.0 at
    dp = 2, each data shard keeps the (token, expert) pairs JAX's keeps;
  * the comm log against ``hlo_comm.summarize`` of JAX's compiled
    program: count, message bytes and wire bytes per kind.  The one
    exception: the HLO carries the collectives over a group of one
    device (the aux loss's all-reduce over a ``data`` axis of size 1,
    the expert all-gathers of ``moe_fsdp`` there), which move nothing;
    the port's convention logs no group of one (``core.comm``), so they
    are taken out of the HLO's count before comparing
    (``_hlo_summary``);
  * ``Model.forward`` logits (1e-4) and aux (1e-5), and prefill + greedy
    decode tokens, equal to JAX's under the same mesh (its greedy tokens
    from its forward, ``_jax_greedy``); the engine and the contiguous
    Scheduler reach the path;
  * the default ``moe_dispatch="gspmd"`` (mesh set or not) and "local"
    without a mesh run the parent's path bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import hlo_comm  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro.runtime import meshctx as jax_meshctx  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import roofline  # noqa: E402
from repro_torch.core.comm import VirtualMesh  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.models.transformer import get_model as port_model  # noqa: E402
from repro_torch.runtime import meshctx  # noqa: E402
from repro_torch.runtime import request as port_request  # noqa: E402
from repro_torch.runtime import scheduler as port_scheduler  # noqa: E402
from repro_torch.runtime.backends import make_backend  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402

ARCHS = ("deepseek-moe-16b", "mixtral-8x22b")
MESHES = ((1, 2), (1, 4), (2, 2), (2, 4))
AXES = ("data", "model")
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 48


def _mesh_param(shape):
    marks = [pytest.mark.multidevice] if shape[0] * shape[1] > 4 else []
    return pytest.param(shape, marks=marks, id=f"{shape[0]}x{shape[1]}")


def _configs(arch, fsdp=False, capacity_factor=None, dispatch="local"):
    out = []
    for c in (jax_config(arch).reduced(), port_config(arch).reduced()):
        c = dataclasses.replace(c, moe_dispatch=dispatch, moe_fsdp=fsdp)
        if capacity_factor is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=capacity_factor))
        out.append(c)
    return out


def _layer(jparams, layer=0):
    jl = {k: v[layer] for k, v in jparams["blocks"].items()}
    return jl, {k: torch.from_numpy(np.array(v)) for k, v in jl.items()}


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def _hlo_summary(compiled):
    """``hlo_comm.summarize`` of a compiled program, less the collectives
    over a group of one device (the named exception)."""
    colls = hlo_comm.parse_hlo_collectives(compiled.as_text())
    return hlo_comm.summarize(c for c in colls if c.group_size > 1)


def _assert_same_collectives(mesh, want):
    """The port's log, in ``hlo_comm.summarize``'s form, equals ``want``:
    per kind the count and message bytes, and the wire bytes."""
    got = roofline.summarize_ops(mesh.summary())
    assert set(got) == set(want)
    for kind, row in want.items():
        assert (got[kind]["count"], got[kind]["msg_bytes"]) == \
            (row["count"], row["msg_bytes"]), kind
        assert got[kind]["wire_bytes"] == pytest.approx(row["wire_bytes"])


@pytest.fixture(autouse=True)
def _no_mesh():
    """Every test starts and ends with no mesh set in either package."""
    meshctx.set_mesh(None)
    jax_meshctx.set_mesh(None)
    yield
    meshctx.set_mesh(None)
    jax_meshctx.set_mesh(None)


# ---------------------------------------------------------------------------
# one layer's experts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fsdp", [False, True], ids=["", "fsdp"])
@pytest.mark.parametrize("shape", [_mesh_param(s) for s in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_local_matches_jax(arch, shape, fsdp):
    """y and aux within 1e-5 of JAX's shard_map path; the comm log equals
    the compiled program's collectives (groups of one device aside)."""
    jcfg, tcfg = _configs(arch, fsdp)
    jl, tl = _layer(jax_model(jcfg).init(jax.random.PRNGKey(1)))
    x = np.random.default_rng(3).standard_normal(
        (4, 16, jcfg.d_model)).astype(np.float32)
    jmesh = jax.make_mesh(shape, AXES)
    fn = jax.jit(lambda p, x: jax_moe.moe_ffn_local(jcfg, p, x, jmesh))
    jy, jaux = fn(jl, jnp.asarray(x))
    mesh = VirtualMesh(shape, AXES)
    ty, taux = port_moe.moe_ffn_local(tcfg, tl, torch.from_numpy(x), mesh)
    _close(ty, jy, STEP_TOL)
    _close(taux, jaux, STEP_TOL)
    want = _hlo_summary(fn.lower(jl, jnp.asarray(x)).compile())
    _assert_same_collectives(mesh, want)
    kinds = {"allreduce"} | ({"allgather"} if fsdp and shape[0] > 1
                             else set())
    assert set(want) == kinds
    # the model all-reduce: one shard's [tokens, h] f32 message
    tokens = 4 * 16 // shape[0]
    assert [(o.collective, o.count, o.shape, o.workers, o.dtype_bytes)
            for o in mesh.summary() if o.collective == "allreduce"][0] == \
        ("allreduce", 1, (tokens, jcfg.d_model), shape[1], 4)


def _jax_kept(jcfg, router, xf, cap):
    """{(token, expert)} that JAX's ``_moe_compute`` keeps on one data
    shard's tokens xf: its routing, stable sort and capacity test."""
    K, E = jcfg.moe.top_k, jcfg.moe.num_experts
    T = xf.shape[0]
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ router, axis=-1)
    _, top_i = jax.lax.top_k(probs, K)
    flat_e = top_i.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    counts = jnp.bincount(flat_e, length=E)
    offsets = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                               jnp.cumsum(counts)[:-1]])
    e_s = flat_e[order]
    keep = np.asarray(jnp.arange(T * K) - offsets[e_s] < cap)
    t_s = np.asarray(jnp.repeat(jnp.arange(T), K)[order])
    return {(int(t), int(e)) for t, e, k in zip(t_s, np.asarray(e_s), keep)
            if k}


@pytest.mark.parametrize("arch", ARCHS)
def test_each_data_shard_drops_what_jax_drops(arch, monkeypatch):
    """Capacity factor 1.0 at mesh (2, 2): each data shard routes its own
    tokens against moe_capacity(B/dp · S); the kept (token, expert) sets
    per shard equal JAX's, some pairs drop, and y matches."""
    jcfg, tcfg = _configs(arch, capacity_factor=1.0)
    jl, tl = _layer(jax_model(jcfg).init(jax.random.PRNGKey(2)))
    x = np.random.default_rng(5).standard_normal(
        (4, 16, jcfg.d_model)).astype(np.float32)
    plans = []
    orig = port_moe.dispatch_plan

    def logged(top_i, num_experts, cap):
        out = orig(top_i, num_experts, cap)
        plans.append((top_i, out[3], cap))
        return out
    monkeypatch.setattr(port_moe, "dispatch_plan", logged)
    ty, _ = port_moe.moe_ffn_local(tcfg, tl, torch.from_numpy(x),
                                   VirtualMesh((2, 2), AXES))
    jmesh = jax.make_mesh((2, 2), AXES)
    jy, _ = jax.jit(lambda p, x: jax_moe.moe_ffn_local(jcfg, p, x, jmesh))(
        jl, jnp.asarray(x))
    _close(ty, jy, STEP_TOL)
    cap = jax_moe.moe_capacity(2 * 16, jcfg)
    assert len(plans) == 2 and all(c == cap for _, _, c in plans)
    dropped = 0
    for shard, (top_i, keep, _) in enumerate(plans):
        kept = {(t, int(top_i[t, k])) for t, k in keep.nonzero().tolist()}
        xf = x[2 * shard:2 * shard + 2].reshape(-1, jcfg.d_model)
        assert kept == _jax_kept(jcfg, jl["router"], jnp.asarray(xf), cap)
        dropped += keep.numel() - len(kept)
    assert dropped > 0


def _parent_moe_compute(cfg, p, xf, cap):
    """The routed experts as the parent commit wrote them, in one
    function, before the routing and the experts were split apart."""
    moe = cfg.moe
    E, K = moe.num_experts, moe.top_k
    T, h = xf.shape
    top_p, top_i, probs = port_moe.route(cfg, p["router"], xf)
    top_i, perm = torch.sort(top_i, dim=-1)
    top_p = top_p.gather(-1, perm)
    order, counts, offsets, keep, slot = port_moe.dispatch_plan(top_i, E, cap)
    frac_tok = counts.float() / (T * K)
    aux = E * torch.sum(probs.mean(dim=0) * frac_tok) * moe.router_aux_coef
    c_idx = torch.arange(cap, device=xf.device)
    filled = c_idx[None, :] < counts[:, None]
    src = torch.where(filled, offsets[:, None] + c_idx[None, :], 0)
    xe = torch.where(filled[..., None], xf[order[src] // K], 0)
    up = torch.bmm(xe, p["we1"])
    gate = F.silu(up) if cfg.activation == "swiglu" else \
        F.gelu(up, approximate="tanh")
    act = gate * torch.bmm(xe, p["we3"])
    ye = torch.bmm(act, p["we2"]).reshape(E * cap, h)
    ye = torch.cat([ye, ye.new_zeros((1, h))])
    weight = (top_p * keep).to(ye.dtype)
    parts = ye[slot] * weight[..., None]
    y = parts[:, 0]
    for k in range(1, K):
        y = y + parts[:, k]
    return y, aux


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ARCHS)
def test_default_path_is_bitwise_the_parents(arch, dtype):
    """``_moe_compute`` (routing and experts now separate functions) is
    bitwise the parent's; the gspmd dispatch with a mesh set, and the
    local dispatch with no mesh, are bitwise the default path, and none
    logs a collective."""
    _, tcfg = _configs(arch, dispatch="gspmd")
    tcfg = dataclasses.replace(tcfg, dtype=str(dtype).split(".")[-1])
    params = port_model(tcfg).init(seed=4, device="cpu")
    tl = {k: v[0] for k, v in params["blocks"].items()}
    xf = torch.randn(40, tcfg.d_model, generator=torch.Generator()
                     .manual_seed(6)).to(dtype)
    cap = port_moe.moe_capacity(40, tcfg)
    got, want = port_moe._moe_compute(tcfg, tl, xf, cap), \
        _parent_moe_compute(tcfg, tl, xf, cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    toks = torch.from_numpy(np.random.default_rng(1).integers(
        2, tcfg.vocab_size, (2, 20)).astype(np.int32))
    ref = port_model(tcfg).forward(params, toks)
    mesh = VirtualMesh((2, 2), AXES)
    meshctx.set_mesh(mesh)
    gspmd = port_model(tcfg).forward(params, toks)
    meshctx.set_mesh(None)
    local_cfg = dataclasses.replace(tcfg, moe_dispatch="local")
    unset = port_model(local_cfg).forward(params, toks)
    for out in (gspmd, unset):
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert mesh.log == []


# ---------------------------------------------------------------------------
# the model, the engine, the scheduler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax params, port cfg, port params) with equal weights, on
    the local dispatch."""
    jcfg, tcfg = _configs(request.param)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, bridge.params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


@pytest.mark.parametrize("shape", [_mesh_param(s) for s in ((1, 2), (2, 2))])
def test_forward_matches_jax_under_the_mesh(pair, shape):
    """Full-sequence logits within 1e-4 and aux within 1e-5 of JAX's
    forward under the same mesh; the comm log of the pass equals the
    compiled forward's collectives (L layers of the FFN's, groups of one
    aside)."""
    jcfg, jp, tcfg, tp = pair
    toks = np.random.default_rng(1).integers(
        2, jcfg.vocab_size, (4, 24)).astype(np.int32)
    jax_meshctx.set_mesh(jax.make_mesh(shape, AXES))
    fwd = jax.jit(jax_model(jcfg).forward)
    jl, jaux = fwd(jp, jnp.asarray(toks))
    want = _hlo_summary(fwd.lower(jp, jnp.asarray(toks)).compile())
    mesh = VirtualMesh(shape, AXES)
    meshctx.set_mesh(mesh)
    tl, taux = port_model(tcfg).forward(tp, torch.from_numpy(toks))
    _close(tl, jl)
    _close(taux, jaux, STEP_TOL)
    _assert_same_collectives(mesh, want)
    assert want["allreduce"]["count"] == tcfg.num_layers * (
        1 + (shape[0] > 1))


def _jax_greedy(jcfg, jp, toks, n):
    """JAX's greedy continuation under the mesh set in its meshctx, by
    its full-sequence forward on a fixed [B, S + n] buffer (one compile):
    the model is causal and the reduced configs drop no pair, so the
    padding after position i moves nothing at i.  (JAX's engine does not
    run its decode under a mesh on the local dispatch in this JAX: its
    shard_map raises "Resource axis: data ... not found in mesh: ()".)"""
    B, S = toks.shape
    buf = np.zeros((B, S + n), np.int32)
    buf[:, :S] = toks
    fwd = jax.jit(jax_model(jcfg).forward)
    for i in range(S, S + n):
        logits, _ = fwd(jp, jnp.asarray(buf))
        buf[:, i] = np.argmax(np.asarray(logits[:, i - 1]), axis=-1)
    return buf[:, S:]


@pytest.mark.parametrize("shape", [_mesh_param(s) for s in ((1, 4), (2, 2))])
def test_engine_tokens_equal_jax_under_the_mesh(pair, shape):
    """Prefill + greedy decode under the mesh (decode_chunk 1 and 8):
    tokens equal JAX's greedy tokens under its mesh; every pass logs one
    model all-reduce a layer of one shard's tokens and no aux all-reduce
    (the passes drop the aux loss, as XLA drops its pmean from JAX's
    compiled prefill)."""
    jcfg, jp, tcfg, tp = pair
    n = 10
    toks = np.random.default_rng(2).integers(
        2, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jax_meshctx.set_mesh(jax.make_mesh(shape, AXES))
    want = _jax_greedy(jcfg, jp, toks, n)
    mesh = VirtualMesh(shape, AXES)
    meshctx.set_mesh(mesh)
    for chunk in (1, 8):
        got = InferenceEngine(tcfg, tp, max_len=MAX_LEN, decode_chunk=chunk,
                              device="cpu").generate(toks, max_new_tokens=n)
        np.testing.assert_array_equal(got.numpy(), want)
    L = tcfg.num_layers
    assert sum(o.count for o in mesh.summary()) == 2 * n * L
    mesh.log.clear()
    model = port_model(tcfg)
    _, cache, pos = model.prefill(tp, torch.from_numpy(toks), MAX_LEN)
    model.decode_step(tp, cache, torch.from_numpy(toks[:, 0]), pos)
    assert [(o.collective, o.count, o.shape, o.workers, o.dtype_bytes)
            for o in mesh.summary()] == [
        ("allreduce", L, (2 * 12 // shape[0], tcfg.d_model), shape[1], 4),
        ("allreduce", L, (2 // shape[0], tcfg.d_model), shape[1], 4)]


def test_scheduler_streams_on_the_local_path(pair):
    """The contiguous Scheduler (``ModelBackend``) under a (1, 2) mesh
    serves a ragged trace through the local path: its streams equal the
    port's engine's per request under the same mesh, and every pass logs
    its model all-reduces."""
    _, _, tcfg, tp = pair
    mesh = VirtualMesh((1, 2), AXES)
    meshctx.set_mesh(mesh)
    rng = np.random.default_rng(0)
    trace = [port_request.Request(
        rid=i, prompt=rng.integers(2, tcfg.vocab_size, s).astype(np.int32),
        max_new_tokens=n) for i, (s, n) in enumerate(((7, 5), (12, 4),
                                                      (5, 6)))]
    backend = make_backend("gspmd", tcfg, tp, num_slots=2, max_len=MAX_LEN,
                           device="cpu")
    report = port_scheduler.Scheduler(
        backend, clock=port_scheduler.VirtualClock()).run(trace)
    assert mesh.log
    streams = report.tokens_by_rid()
    for req in trace:
        solo = InferenceEngine(tcfg, tp, max_len=MAX_LEN, device="cpu")
        assert streams[req.rid] == solo.generate(
            req.prompt[None], max_new_tokens=req.max_new_tokens)[0].tolist()
