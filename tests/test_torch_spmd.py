"""The port's sharded (GSPMD-style) step on a ``DeviceMesh`` against JAX's
compiled step on a host mesh.

  * Collectives: reduced granite-8b, gemma-7b and hubert-xlarge (4 query
    and 4 KV heads each) on (data, model) = (1, 2), (2, 2), (2, 4), where
    the heads divide "model".  ``core.step_comm.summarize`` of the port's
    prefill (the encoder's forward) and serve step on a fake process group
    equals ``hlo_comm.summarize`` of JAX's compiled step — kind, count and
    message bytes — and the train step's message bytes per kind equal
    JAX's (XLA combines the gradient all-reduces, so the counts are
    printed).  Each also equals ``step_comm.closed_form``.
  * Heads that do not divide "model": reduced paligemma-3b (1 KV head) on
    (1, 2) and (2, 2), prefill and train, held to the closed form; JAX's
    summary (its own layout) is printed beside it.
  * Values: one spawn of 4 gloo ranks on meshes (2, 2) and (1, 4), the
    latter with the sequence-parallel decode (reduced granite-8b with 2 KV
    heads): logits within 1e-4 of the unsharded plain path and of JAX's
    forward, greedy tokens over 8 decode steps equal to both, and one
    train step held to JAX's (``value_and_grad`` and ``make_train_step``
    on the same weights and batch) and to the unsharded step: the loss
    within 1e-5, grad_norm within 1e-5 relative, every gradient leaf
    within 1e-5 + 1e-4·|g| of JAX's, and each leaf's update within 1e-3
    of the references' (norms).
  * ``op_cost``'s per-chip walk: FLOPs within 2% of the per-device module
    JAX compiles (``hlo_cost``'s count, loops expanded: XLA's own
    ``cost_analysis()`` counts a scanned layer's body once, so it is
    printed, not held).
  * ``layers.chunked_gqa_attention`` against JAX's within 1e-5 (f32).
  * ``SyntheticTokens.global_array``: each rank's block is ``batch_at``'s.
  * Full width: granite-8b ``prefill_32k`` on (16, 16) through
    ``launch.dryrun.run_one``: the collectives equal the closed form, and
    every tensor the step makes is a meta tensor.

The JAX meshes are built here with ``AxisType.Auto`` axes on the
conftest's 8 host devices (jax 0.9's ``make_mesh`` defaults to explicit
axes, under which JAX's embedding gather does not lower: ROADMAP C16).
"""
import dataclasses
import functools
import json
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.config.base import ShapeConfig as JShape  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import hlo_comm, hlo_cost  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro.runtime.engine import make_serve_step as jax_serve_step  # noqa: E402
from repro.runtime.train import make_loss_fn as jax_loss_fn  # noqa: E402
from repro.runtime.train import make_train_step as jax_train_step  # noqa: E402
from repro_torch.config.base import ShapeConfig  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import op_cost, step_comm  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.transformer import get_model  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.runtime import meshctx  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402
from repro_torch.runtime.engine import make_serve_step  # noqa: E402
from repro_torch.runtime.train import make_train_step  # noqa: E402

import torch_spmd_ranks  # noqa: E402  (tests/: the gloo ranks' program)

_FAST = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
ARCHS = ["granite-8b", "gemma-7b", "hubert-xlarge"]
MESHES = [(1, 2), (2, 2), (2, 4)]
B, S = 4, 16


@pytest.fixture(autouse=True)
def _no_mesh_after():
    yield
    meshctx.set_device_mesh(None)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _seq(cfg):
    """The sequence a prefill or train batch spans (the vlm's prefix
    included)."""
    return S + (cfg.num_prefix_tokens if cfg.family == "vlm" else 0)


def _cfgs(arch, kv=None):
    jcfg, tcfg = jax_config(arch).reduced(), port_config(arch).reduced()
    if kv is not None:
        jcfg = dataclasses.replace(jcfg, num_kv_heads=kv)
        tcfg = dataclasses.replace(tcfg, num_kv_heads=kv)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_text(arch, mesh_shape, mode):
    """The per-device HLO text of JAX's compiled step on a host mesh of
    ``mesh_shape`` with Auto axes."""
    jcfg, _ = _cfgs(arch)
    mesh = jax.make_mesh(mesh_shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    model = jax_model(jcfg)
    with mesh:
        params, pspecs = jax_specs.param_sds(jcfg, mesh)
        if mode == "prefill":
            shape = JShape("x", _seq(jcfg), B, "prefill")
            batch, _ = jax_specs.batch_specs(jcfg, shape, mesh)

            def f(params, **kw):
                if jcfg.family == "encoder":
                    return model.forward(params, features=kw["features"])[0]
                lg, cache, _ = model.prefill(params, kw["tokens"],
                                             max_len=shape.seq_len,
                                             prefix_emb=kw.get("prefix_emb"))
                return lg, cache
            lowered = jax.jit(f).lower(params, **batch)
        elif mode == "decode":
            tok, pos, cache = jax_specs.decode_specs(
                jcfg, JShape("x", S, B, "decode"), mesh)
            lowered = jax.jit(jax_serve_step(model), donate_argnums=(1,)
                              ).lower(params, cache, tok, pos)
        else:
            opt = JAdamW()
            opt_specs = {"m": pspecs, "v": pspecs, "step": JP()}
            o = jax.tree.map(
                lambda s, spc: jax.ShapeDtypeStruct(
                    s.shape, s.dtype, sharding=NamedSharding(mesh, spc)),
                jax.eval_shape(opt.init, params), opt_specs,
                is_leaf=lambda x: isinstance(x, (jax.ShapeDtypeStruct, JP)))
            batch, _ = jax_specs.batch_specs(
                jcfg, JShape("x", _seq(jcfg), B, "train"), mesh)
            lowered = jax.jit(jax_train_step(model, opt)).lower(params, o,
                                                                batch)
        compiled = lowered.compile(_FAST)
    return compiled.as_text(), (compiled.cost_analysis() or {}).get("flops")


def _port_step(tcfg, mesh_shape, mode, walk=False):
    """(summary of the collectives, the closed form, the op walk's Cost or
    None) of the port's step on meta tensors over a fake group."""
    vm = make_mesh(mesh_shape, ("data", "model"))
    dmesh = sh.fake_device_mesh(vm)
    meshctx.set_device_mesh(dmesh)
    params, _ = specs.param_sds(tcfg, dmesh)
    model = get_model(tcfg, plain=True)
    St = _seq(tcfg)
    if mode == "prefill":
        batch, _ = specs.batch_specs(tcfg, ShapeConfig("x", St, B,
                                                       "prefill"), dmesh)

        def fn():
            if tcfg.family == "encoder":
                return model.forward(params, features=batch["features"])
            return model.prefill(params, batch["tokens"], St,
                                 prefix_emb=batch.get("prefix_emb"))
        form = step_comm.closed_form(tcfg, "prefill", vm.shape, B, St)
    elif mode == "decode":
        (tok, _, cache), _ = specs.decode_specs(
            tcfg, ShapeConfig("x", S, B, "decode"), dmesh)

        def fn():
            return make_serve_step(model)(params, cache, tok, S - 1)
        form = step_comm.closed_form(tcfg, "decode", vm.shape, B, 1,
                                     cache_width=S)
    else:
        batch, _ = specs.batch_specs(tcfg, ShapeConfig("x", St, B, "train"),
                                     dmesh)
        opt = AdamW()
        state = opt.init(params)
        step = make_train_step(model, opt, device="meta")

        def fn():
            return step(params, state, batch)
        form = step_comm.closed_form(
            tcfg, "train", vm.shape, B, St,
            param_bytes=step_comm.local_param_bytes(params))
    ctx = torch.enable_grad() if mode == "train" else torch.no_grad()
    with ctx:
        _, log = step_comm.record(fn)
        cost = op_cost.count(fn) if walk else None
    assert not step_comm.trivial(log)
    return step_comm.summarize(log), form, cost


def _rows(summary):
    return {k: (v["count"], v["msg_bytes"]) for k, v in summary.items()}


CASES = [(a, m, mode) for a in ARCHS for m in MESHES
         for mode in ("prefill", "decode", "train")
         if not (a == "hubert-xlarge" and mode == "decode")]


@pytest.mark.parametrize("arch,mesh_shape,mode", CASES,
                         ids=[f"{a}-{m[0]}x{m[1]}-{mode}"
                              for a, m, mode in CASES])
def test_collectives_match_jax(arch, mesh_shape, mode):
    """Where the heads divide "model", the port's step issues JAX's
    compiled collectives (train: the same bytes per kind), and both equal
    the closed form."""
    _, tcfg = _cfgs(arch)
    got, form, _ = _port_step(tcfg, mesh_shape, mode)
    text, _ = _jax_text(arch, mesh_shape, mode)
    want = hlo_comm.summarize(hlo_comm.parse_hlo_collectives(text))
    print(f"{arch} {mesh_shape} {mode}: port {_rows(got)} jax {_rows(want)}")
    assert step_comm.same(got, form)
    if mode == "train":
        assert {k: v["msg_bytes"] for k, v in got.items()} == \
            {k: v["msg_bytes"] for k, v in want.items()}
    else:
        assert _rows(got) == _rows(want)


@pytest.mark.parametrize("mode", ["prefill", "train"])
@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)],
                         ids=["1x2", "2x2"])
def test_non_dividing_heads_hold_the_closed_form(mesh_shape, mode):
    """paligemma-3b's one KV head on a model axis of 2: K and V gathered
    (and their gradients reduce-scattered), as the closed form says;
    JAX's own layout is printed beside it."""
    _, tcfg = _cfgs("paligemma-3b")
    got, form, _ = _port_step(tcfg, mesh_shape, mode)
    text, _ = _jax_text("paligemma-3b", mesh_shape, mode)
    want = hlo_comm.summarize(hlo_comm.parse_hlo_collectives(text))
    print(f"paligemma {mesh_shape} {mode}: port {_rows(got)} "
          f"closed form {_rows(form)} jax {_rows(want)}")
    assert "allgather" in got
    assert step_comm.same(got, form)


@pytest.mark.parametrize("width,layout", [(16, "seq"), (18, "replicated")])
def test_decode_layouts_hold_the_closed_form(width, layout):
    """2 KV heads on a model axis of 4: a cache of 16 rows splits them
    over "model" (the partial softmax's MAX and SUM all-reduces), one of
    18 cannot and is whole on every rank; both all-gather q, k and v."""
    from repro_torch.models.blocks import kv_layout
    _, tcfg = _cfgs("granite-8b", kv=2)
    vm = make_mesh((1, 4), ("data", "model"))
    dmesh = sh.fake_device_mesh(vm)
    meshctx.set_device_mesh(dmesh)
    params, _ = specs.param_sds(tcfg, dmesh)
    (tok, _, cache), _ = specs.decode_specs(
        tcfg, ShapeConfig("x", width, B, "decode"), dmesh)
    with torch.no_grad():
        _, log = step_comm.record(make_serve_step(get_model(tcfg, plain=True)),
                                  params, cache, tok, width - 1)
    got = step_comm.summarize(log)
    form = step_comm.closed_form(tcfg, "decode", vm.shape, B, 1,
                                 cache_width=width)
    print(layout, _rows(got), _rows(form))
    assert kv_layout(tcfg, 4, width) == layout
    assert step_comm.same(got, form)
    L = tcfg.num_layers
    assert got["allgather"]["count"] == 3 * L + 2
    assert got["allreduce"]["count"] == 2 * L + 1 + (2 * L if layout == "seq"
                                                     else 0)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=["1x2", "2x2", "2x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_op_cost_per_chip_flops_match_jax(arch, mesh_shape):
    """The walk of rank 0's local prefill counts the FLOPs of JAX's
    per-device module within 2%."""
    _, tcfg = _cfgs(arch)
    _, _, cost = _port_step(tcfg, mesh_shape, "prefill", walk=True)
    text, cost_analysis = _jax_text(arch, mesh_shape, "prefill")
    flops, _ = hlo_cost.analyze_flops_bytes(text)
    print(f"{arch} {mesh_shape}: port {cost.flops:.6g} jax {flops:.6g} "
          f"(cost_analysis {cost_analysis:.6g}); peak live "
          f"{cost.peak_bytes:.6g} B")
    assert cost.flops == pytest.approx(flops, rel=0.02)
    assert cost.peak_bytes > 0


# ---------------------------------------------------------------------------
# values on four gloo ranks
# ---------------------------------------------------------------------------

# (arch, KV heads or None, mesh, what to check)
VALUE_RUNS = [("granite-8b", None, (2, 2), ("decode", "train")),
              ("gemma-7b", None, (2, 2), ("decode",)),
              ("paligemma-3b", None, (2, 2), ("decode",)),
              ("hubert-xlarge", None, (1, 4), ()),
              ("granite-8b", 2, (1, 4), ("decode", "train"))]
NEW = 8
# a leaf's update against the reference's, |Δ - Δ_ref| / |Δ_ref| (norms):
# 1.0e-4 to 2.8e-4 observed (f32 noise in gradients near Adam's eps); an
# update that moved nothing is 1
UPDATE_TOL = 1e-3


def _inputs(tcfg):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": toks}
    if tcfg.family == "vlm":
        out["prefix_emb"] = rng.standard_normal(
            (B, tcfg.num_prefix_tokens, tcfg.d_model)).astype(np.float32)
    if tcfg.family == "encoder":
        out = {"features": rng.standard_normal(
            (B, S, tcfg.d_model)).astype(np.float32),
            "targets": toks % tcfg.vocab_size}
    return out


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(_FAST)(*args)


def _jax_train(model, jp, inp):
    """JAX's train step on the inputs, in its two parts (``make_train_step``
    is ``value_and_grad`` of the loss, then ``AdamW.update``): its loss,
    grad_norm, gradients and updated parameters, numpy."""
    batch = {k: jnp.asarray(v) for k, v in inp.items()}
    (loss, _), grads = _jit(jax.value_and_grad(jax_loss_fn(model),
                                               has_aux=True), jp, batch)
    opt = JAdamW()
    params, _, met = _jit(opt.update, grads, opt.init(jp), jp)
    return {"loss": float(loss), "grad_norm": float(met["grad_norm"]),
            "grads": jax.tree.map(np.asarray, grads),
            "params": jax.tree.map(np.asarray, params)}


def _jax_reference(arch, kv, checks):
    """(numpy params, inputs, JAX's logits, JAX's greedy tokens over a
    prefill and NEW decode steps or None for the encoder, JAX's train
    step or None), jitted."""
    jcfg, tcfg = _cfgs(arch, kv)
    model = jax_model(jcfg)
    jp = model.init(jax.random.PRNGKey(0))
    inp = _inputs(tcfg)
    train = _jax_train(model, jp, inp) if "train" in checks else None
    if jcfg.family == "encoder":
        logits, _ = _jit(lambda p, f: model.forward(p, features=f),
                         jp, jnp.asarray(inp["features"]))
        return (jax.tree.map(np.asarray, jp), inp, np.asarray(logits), None,
                train)
    toks = jnp.asarray(inp["tokens"])
    pfx = inp.get("prefix_emb")
    pfx = None if pfx is None else jnp.asarray(pfx)
    logits, _ = _jit(lambda p, t, x: model.forward(p, t, prefix_emb=x),
                     jp, toks, pfx)
    lg, cache, pos = _jit(
        lambda p, t, x: model.prefill(p, t, max_len=32, prefix_emb=x),
        jp, toks, pfx)
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    step = jax.jit(model.decode_step).lower(jp, cache, tok, pos).compile(
        _FAST)
    out = [np.asarray(tok)]
    for i in range(NEW):
        lg, cache = step(jp, cache, tok, pos + i)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return (jax.tree.map(np.asarray, jp), inp, np.asarray(logits),
            np.stack(out, 1), train)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def value_results(tmp_path_factory):
    import torch.multiprocessing as mp
    refs = [_jax_reference(arch, kv, checks)
            for arch, kv, _, checks in VALUE_RUNS]
    out = str(tmp_path_factory.mktemp("spmd") / "values.json")
    mp.spawn(torch_spmd_ranks.values_rank,
             args=(4, _free_port(), VALUE_RUNS, refs, NEW, out), nprocs=4)
    with open(out) as f:
        return {r["case"]: r for r in json.load(f)}


@pytest.mark.parametrize("arch,kv,mesh_shape,checks", VALUE_RUNS,
                         ids=[f"{a}-kv{kv}-{m[0]}x{m[1]}"
                              for a, kv, m, _ in VALUE_RUNS])
def test_sharded_values_on_gloo_ranks(value_results, arch, kv, mesh_shape,
                                      checks):
    row = value_results[f"{arch}-kv{kv}-{mesh_shape}"]
    print(row)
    tol = 1e-4 * max(1.0, row["logit_scale"])
    assert row["logit_err_plain"] <= tol
    assert row["logit_err_jax"] <= tol
    if "decode" in checks:
        assert row["tokens_equal_plain"] and row["tokens_equal_jax"]
    if "train" in checks:
        for ref in ("loss_plain", "loss_jax"):
            assert abs(row["loss"] - row[ref]) <= 1e-5
        assert abs(row["grad_norm"] - row["grad_norm_jax"]) <= \
            1e-5 * row["grad_norm_jax"]
        assert row["grad_excess"] <= 0.0
        assert row["update_err_jax"] <= UPDATE_TOL
        assert row["update_err_plain"] <= UPDATE_TOL


# ---------------------------------------------------------------------------
# chunked attention, global_array, the full-width dry run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,window,prefix", [
    ("causal", None, 0), ("causal", 5, 0), ("bidirectional", None, 0),
    ("prefix", None, 6), ("prefix", 7, 6)])
def test_chunked_gqa_attention_matches_jax(mode, window, prefix):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    want = jax_layers.chunked_gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jax_layers.MaskSpec(mode=mode, window=window, prefix_len=prefix),
        kv_chunk=8)
    got = layers.chunked_gqa_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mode=mode, window=window, prefix_len=prefix, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    dense = layers.gqa_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        layers.make_mask(24, 24, mode=mode, window=window,
                         prefix_len=prefix))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5)


def test_prefill_honours_attention_impl():
    """``attention_impl="chunked"`` runs the chunked path on the plain
    model, with the dense path's logits."""
    _, tcfg = _cfgs("granite-8b")
    ccfg = dataclasses.replace(tcfg, attention_impl="chunked",
                               attention_chunk=8)
    params = get_model(tcfg, plain=True).init(seed=0, device="cpu")
    toks = torch.from_numpy(_inputs(tcfg)["tokens"])
    calls = []
    orig = layers.chunked_gqa_attention

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    layers.chunked_gqa_attention = counted
    try:
        with torch.no_grad():
            got = get_model(ccfg, plain=True).prefill(params, toks, S)[0]
    finally:
        layers.chunked_gqa_attention = orig
    with torch.no_grad():
        want = get_model(tcfg, plain=True).prefill(params, toks, S)[0]
    assert len(calls) == tcfg.num_layers
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rank", [0, 3, 6])
def test_global_array_shards_equal_batch_at(rank):
    """On a (data=2, model=4) mesh of a fake group, rank r's block of the
    batch split over "data" is ``batch_at``'s rows of its data shard."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=8)
    dmesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data",
                                                            "model"))
    data = SyntheticTokens(vocab_size=500, seq_len=12, global_batch=6,
                           seed=7, doc_len=5)
    arr = data.global_array(3, dmesh, sh.P("data", None))
    lo = (rank // 4) * 3
    assert tuple(arr.shape) == (6, 12)
    np.testing.assert_array_equal(arr.to_local().numpy(),
                                  data.batch_at(3, lo, lo + 3))
    both = data.global_array(3, dmesh, sh.P("data", "model"))
    c0 = (rank % 4) * 3
    np.testing.assert_array_equal(both.to_local().numpy(),
                                  data.batch_at(3, lo, lo + 3)[:, c0:c0 + 3])


from torch._subclasses.fake_tensor import FakeTensor  # noqa: E402


class _Allocated(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the bytes of the tensors local ops make off the meta
    device (DTensor's sharding propagation runs on fake tensors, which
    hold nothing)."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and t.device.type != "meta"
                    and not isinstance(t, FakeTensor)):
                self.nbytes += t.numel() * t.element_size()
        return out


def test_full_width_dry_run_matches_the_closed_form():
    """granite-8b prefill_32k on (16, 16): 2L + 1 all-reduces and 2L
    all-gathers of K and V (8 KV heads on 16); no tensor but the mesh's
    small index tables (under 1 MiB in all) is made off the meta
    device."""
    from repro_torch.launch import dryrun
    with _Allocated() as made:
        rec = dryrun.run_one("granite-8b", "prefill_32k", False)
    assert made.nbytes < 1 << 20
    assert rec["status"] == "ok" and rec["collectives_match"]
    L = port_config("granite-8b").num_layers
    assert rec["collectives"]["allreduce"]["count"] == 2 * L + 1
    assert rec["collectives"]["allgather"]["count"] == 2 * L
    assert rec["roofline"]["flops_per_chip"] > 0
    skip = dryrun.run_one("deepseek-moe-16b", "train_4k", False)
    assert skip["status"] == "not_ported"
    assert os.path.basename(dryrun.RESULTS_DIR) == "dryrun_torch"
