"""The port's explicit TP engine on virtual ranks against the JAX package.

Reduced llama32-3b in float32 under the conftest's 8-device host mesh:
at t = 2 its num_kv_heads = 2 variant (one KV head and two query heads per
rank, so GQA is exercised), at t = 4 the reduced config itself (one of
each per rank).  Weights come from the JAX package's ``Model.init`` and
cross over through numpy; tokens are made with numpy from a seed.

* ``shard_params`` rank r is the block ``NamedSharding(mesh,
  tp_param_specs(cfg))`` places on device r.
* ``tp_prefill``, ``tp_decode_step``, ``tp_generate`` and
  ``tp_paged_step`` (a chunk, then decode steps) equal JAX's: logits and
  caches within 1e-4 absolute and relative (f32 sums in another order),
  greedy tokens identical.
* Quantized decode (int8, fp8, int4) against JAX's quantized decode,
  teacher-forced: top-1 match >= 0.90 and logit drift <= 0.25.
* The comm log of a prefill and a decode step equals
  ``commodel.comm_ops_for``, and its decode counts equal what
  ``repro.core.hlo_comm`` reads off JAX's compiled ``tp_decode_step``.
* ``TPBackend`` at t = 2, contiguous and paged, gives the tokens of JAX's
  ``TPBackend`` and of the port's t = 1 ``ModelBackend`` through
  ``Scheduler``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import parallel_exec as jpx  # noqa: E402
from repro.core.hlo_comm import parse_hlo_collectives, summarize  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro.runtime import backends as jax_backends  # noqa: E402
from repro.runtime import request as jax_request  # noqa: E402
from repro.runtime import scheduler as jax_scheduler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import comm  # noqa: E402
from repro_torch.core.commodel import comm_ops_for  # noqa: E402
from repro_torch.core.parallel_exec import TPModel, shard_params  # noqa: E402
from repro_torch.kernels.quant_collective import QUANT_TOLERANCE  # noqa: E402
from repro_torch.models.transformer import get_model as port_model  # noqa: E402
from repro_torch.runtime import request as port_request  # noqa: E402
from repro_torch.runtime import scheduler as port_scheduler  # noqa: E402
from repro_torch.runtime.backends import make_backend  # noqa: E402

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 host-platform devices")
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, W = 2, 8, 24


@functools.lru_cache(maxsize=None)
def _setup(t):
    """(t, jax cfg, jax params, port cfg, port params, port shards)."""
    jcfg = jax_config("llama32-3b").reduced()
    tcfg = port_config("llama32-3b").reduced()
    if t == 2:
        jcfg = dataclasses.replace(jcfg, num_kv_heads=2)
        tcfg = dataclasses.replace(tcfg, num_kv_heads=2)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     tcfg, device="cpu")
    return t, jcfg, jparams, tcfg, tparams, shard_params(tcfg, tparams, t)


@pytest.fixture(scope="module", params=[2, 4], ids=["t2", "t4"])
def tp(request):
    return _setup(request.param)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


def _cat(cache, key):
    """Per-rank caches side by side on the KV-head axis: the global cache."""
    return torch.cat([c[key] for c in cache], dim=3)


def _copy(cache):
    return [{k: v.clone() for k, v in c.items()} for c in cache]


@needs_mesh
def test_shard_params_match_named_sharding(tp):
    t, jcfg, jparams, tcfg, _, shards = tp
    mesh = jpx.make_tp_mesh(t)
    specs = jpx.tp_param_specs(jcfg)
    placed = jax.device_put(jparams, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs))
    pos = {d: r for r, d in enumerate(mesh.devices.flat)}

    def check(arr, port_pieces):
        for shard in arr.addressable_shards:
            np.testing.assert_array_equal(
                port_pieces[pos[shard.device]].numpy(),
                np.asarray(shard.data))

    for name in ("embed", "lm_head", "final_norm"):
        check(placed[name], [s[name] for s in shards])
    for name in placed["blocks"]:
        check(placed["blocks"][name], [s["blocks"][name] for s in shards])
    assert all(s["blocks"]["wo"].is_contiguous() for s in shards)


@needs_mesh
def test_prefill_decode_generate_match_jax(tp):
    t, jcfg, jparams, tcfg, _, shards = tp
    mesh = jpx.make_tp_mesh(t)
    toks = _tokens(tcfg, (B, S))
    jl, jcache = jpx.tp_prefill(jcfg, mesh, cache_w=W)(jparams,
                                                       jnp.asarray(toks))
    model = TPModel(tcfg, t)
    tl, tcache = model.tp_prefill(shards, torch.from_numpy(toks), W)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(_cat(tcache, key), jcache[key])
    # one step at per-sequence positions, as the serving backend runs it
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    pos = np.array([S, S - 3], np.int32)
    step = jpx.tp_decode_step(jcfg, mesh, vector_pos=True)
    jl2, jc2 = step(jparams, jax.tree.map(jnp.copy, jcache),
                    jnp.asarray(tok), jnp.asarray(pos))
    tl2, tc2 = model.tp_decode_step(shards, _copy(tcache),
                                    torch.from_numpy(tok),
                                    torch.from_numpy(pos))
    _close(tl2, jl2)
    for key in ("k", "v"):
        _close(_cat(tc2, key), jc2[key])
    # greedy generation, scalar position
    gen = jpx.tp_generate(jcfg, mesh, num_tokens=6)
    jt, _ = gen(jparams, jax.tree.map(jnp.copy, jcache), jnp.asarray(tok),
                jnp.int32(S))
    tt, _ = model.tp_generate(shards, _copy(tcache), torch.from_numpy(tok),
                              S, 6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@needs_mesh
def test_paged_chunk_then_decode_matches_jax(tp):
    t, jcfg, jparams, tcfg, _, shards = tp
    mesh = jpx.make_tp_mesh(t)
    ps, P = 4, 9
    bt = np.array([[3, 1, 7, 5], [2, 8, 4, 6]], np.int32)
    toks = _tokens(tcfg, (B, S + 3), seed=1)
    jfn = jpx.tp_paged_step(jcfg, mesh, donate=False)
    shape = (jcfg.num_layers, P, ps, jcfg.num_kv_heads, jcfg.head_dim)
    jcache = {k: jnp.zeros(shape, jnp.float32) for k in ("k", "v")}
    model = TPModel(tcfg, t)
    tcache = model.init_paged_cache(P, ps, device="cpu")
    pos = np.zeros(B, np.int32)
    chunks = [toks[:, :S]] + [toks[:, S + i:S + i + 1] for i in range(3)]
    for chunk in chunks:
        jl, jcache = jfn(jparams, jcache, jnp.asarray(chunk),
                         jnp.asarray(pos), jnp.asarray(bt))
        tl, tcache = model.tp_paged_step(shards, tcache,
                                         torch.from_numpy(chunk),
                                         torch.from_numpy(pos),
                                         torch.from_numpy(bt))
        _close(tl, jl)
        pos = pos + chunk.shape[1]
    for key in ("k", "v"):
        _close(_cat(tcache, key), jcache[key])


def _teacher_forced(step_fn, cache, toks, start):
    rows = []
    for i in range(toks.shape[1]):
        logits, cache = step_fn(cache, toks[:, i], start + i)
        rows.append(np.asarray(logits, np.float32))
    return np.stack(rows)


@needs_mesh
@pytest.mark.parametrize("quant", ["int8", "fp8", "int4"])
def test_quantized_decode_matches_jax(tp, quant):
    t, jcfg, jparams, tcfg, _, shards = tp
    mesh = jpx.make_tp_mesh(t)
    toks = _tokens(tcfg, (B, S))
    forced = _tokens(tcfg, (B, 12), seed=2)
    _, jcache = jpx.tp_prefill(jcfg, mesh, cache_w=W)(jparams,
                                                      jnp.asarray(toks))
    jstep = jpx.tp_decode_step(jcfg, mesh, quant_collectives=quant)
    want = _teacher_forced(
        lambda c, tok, p: jstep(jparams, c, jnp.asarray(tok), jnp.int32(p)),
        jax.tree.map(jnp.copy, jcache), forced, S)
    model = TPModel(tcfg, t, quant=quant)
    _, tcache = model.tp_prefill(shards, torch.from_numpy(toks), W)
    got = _teacher_forced(
        lambda c, tok, p: model.tp_decode_step(shards, c,
                                               torch.from_numpy(tok), p),
        tcache, forced, S)
    match = float((got.argmax(-1) == want.argmax(-1)).mean())
    drift = float(np.abs(got - want).max())
    assert match >= 0.90, (match, drift)
    assert drift <= 0.25, (match, drift)
    assert drift <= QUANT_TOLERANCE[quant]["logit_drift_ceiling"]


@needs_mesh
@pytest.mark.parametrize("quant", [None, "int8", "fp8", "int4"])
def test_comm_log_matches_commodel_and_compiled_hlo(tp, quant):
    t, jcfg, jparams, tcfg, _, shards = tp
    toks = _tokens(tcfg, (B, S))
    model = TPModel(tcfg, t, quant=quant)
    logits, cache = model.tp_prefill(shards, torch.from_numpy(toks), W)
    model.tp_decode_step(shards, cache, logits.argmax(-1).to(torch.int32),
                         S)
    want = comm_ops_for(tcfg, S, 2, t, batch=B, b=4,
                        gather_mode="allgather", quant=quant)
    assert comm.fold(model.group.summary()) == comm.fold(want)
    decode = [o for o in model.group.summary() if o.phase == "decode"]
    mesh = jpx.make_tp_mesh(t)
    _, jcache = jpx.tp_prefill(jcfg, mesh, cache_w=W)(jparams,
                                                      jnp.asarray(toks))
    step = jpx.tp_decode_step(jcfg, mesh, quant_collectives=quant)
    hlo = step.lower(jparams, jcache, jnp.zeros((B,), jnp.int32),
                     jnp.int32(S)).compile().as_text()
    compiled = {k: v["count"]
                for k, v in summarize(parse_hlo_collectives(hlo)).items()}
    assert comm.counts_by_collective(decode) == compiled
    L = tcfg.num_layers
    assert compiled["allreduce"] == 2 * L + 1
    assert compiled["allgather"] == (1 if quant is None else 2 * L + 1)


def _trace(module, cfg):
    rng = np.random.default_rng(0)
    spec = [(7, 6, 0.0), (12, 4, 0.0), (5, 9, 0.5), (9, 3, 0.5), (11, 5, 2.0)]
    return [module.Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, s),
                           max_new_tokens=n, arrival=a)
            for i, (s, n, a) in enumerate(spec)]


@needs_mesh
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_tp_backend_serves_like_jax_and_one_device(paged):
    _, jcfg, jparams, tcfg, tparams, _ = _setup(2)
    kw = dict(paged=True, page_size=4) if paged else {}
    jb = jax_backends.make_backend("tp", jcfg, jparams, num_slots=2,
                                   max_len=32, t=2, **kw)
    want = jax_scheduler.Scheduler(
        jb, clock=jax_scheduler.VirtualClock()).run(_trace(jax_request, jcfg))
    reports = {}
    for kind, deg in (("tp", 2), ("gspmd", 1)):
        backend = make_backend(kind, tcfg, tparams, num_slots=2, max_len=32,
                               t=deg, device="cpu", **kw)
        reports[kind] = port_scheduler.Scheduler(
            backend, clock=port_scheduler.VirtualClock()).run(
            _trace(port_request, tcfg))
    assert reports["tp"].tokens_by_rid() == want.tokens_by_rid()
    assert reports["gspmd"].tokens_by_rid() == want.tokens_by_rid()
    steps = [(r.phase, r.n_active, r.collective_counts)
             for r in reports["tp"].steps]
    assert steps == [(r.phase, r.n_active, r.collective_counts)
                     for r in want.steps]


def test_quantized_tp_backend_serves_every_request():
    """int8 at t = 4: every request finishes, the predicted decode rows are
    the quantized ones, and the paged/quantized and single-device/quantized
    combinations are refused as in the JAX package."""
    cfg = port_config("llama32-3b").reduced()
    params = port_model(cfg).init(seed=0, device="cpu")
    backend = make_backend("tp", cfg, params, num_slots=2, max_len=32, t=4,
                           quant_collectives="int8", device="cpu")
    report = port_scheduler.Scheduler(
        backend, clock=port_scheduler.VirtualClock()).run(
        _trace(port_request, cfg))
    assert [m.num_generated for m in report.metrics] == [6, 4, 9, 3, 5]
    decode = comm.counts_by_collective(backend.decode_comm_ops(batch=2))
    L = cfg.num_layers
    assert decode == {"allreduce": 2 * L + 1, "reducescatter": 2 * L,
                      "allgather": 2 * L + 1}
    kinds = {r.kind for r in backend.model.group.log if r.phase == "decode"}
    assert kinds == {"allreduce", "reducescatter", "allgather"}
    with pytest.raises(ValueError, match="contiguous decode"):
        make_backend("tp", cfg, params, num_slots=2, t=2, paged=True,
                     quant_collectives="int8", device="cpu")
    with pytest.raises(ValueError, match="explicit engines"):
        make_backend("gspmd", cfg, params, num_slots=2,
                     quant_collectives="int8", device="cpu")
    with pytest.raises(ValueError, match="t >= 2"):
        make_backend("tp", cfg, params, num_slots=2, t=1, device="cpu")


def test_tp_refuses_what_the_jax_engine_does_not_cover():
    with pytest.raises(ValueError, match="tie_embeddings"):
        TPModel(port_config("gemma-7b").reduced(), 2)
    with pytest.raises(ValueError, match="num_heads"):
        TPModel(port_config("llama32-3b").reduced(), 3)
    with pytest.raises(ValueError, match="unknown quant"):
        TPModel(port_config("llama32-3b").reduced(), 2, quant="int2")


def test_tp_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = port_config("llama32-3b").reduced()
    params = port_model(cfg).init(seed=0, device="cpu")
    model = TPModel(cfg, 2)
    for call in (lambda: model.init(seed=0),
                 lambda: model.init_cache(2, 16),
                 lambda: model.init_paged_cache(4, 4),
                 lambda: make_backend("tp", cfg, params, num_slots=2, t=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
