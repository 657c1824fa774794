"""The port's hybrid-head family (hymba-1.5b) against the JAX package.

The selective scan (the per-token recurrence and the chunked form), the
mamba branch inside the block, the model, the engine and the contiguous
Scheduler are held to the JAX package on the CPU at reduced width in f32,
with weights carried across through numpy (``repro_torch.bridge``) and
inputs made by numpy from a seed.  hymba's reduced window is 64, so the
80-token sequences and the 70-token prompt run the windowed prefill and
wrap the ring cache in decode.  On the CPU the attention and norm
wrappers run their plain versions; the kernels are held to those on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: 1e-5 absolute and relative for the scans and one block, 1e-4
for whole-model logits — the two frameworks sum the same f32 products in
another order (observed ~4e-6).  Greedy tokens and streams must be
identical.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import hybrid as jax_hybrid  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro.runtime import backends as jax_backends  # noqa: E402
from repro.runtime import request as jax_request  # noqa: E402
from repro.runtime import scheduler as jax_scheduler  # noqa: E402
from repro.runtime.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import hybrid as port_hybrid  # noqa: E402
from repro_torch.models.transformer import get_model as port_model  # noqa: E402
from repro_torch.runtime import request as port_request  # noqa: E402
from repro_torch.runtime import scheduler as port_scheduler  # noqa: E402
from repro_torch.runtime.backends import make_backend  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402

ARCH = "hymba-1.5b"
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 96


def _configs(scan_impl="step"):
    jcfg, tcfg = jax_config(ARCH).reduced(), port_config(ARCH).reduced()
    if scan_impl != "step":
        jcfg, tcfg = (dataclasses.replace(c, ssm=dataclasses.replace(
            c.ssm, scan_impl=scan_impl, scan_chunk=16)) for c in (jcfg, tcfg))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port cfg, port params) with equal weights."""
    jcfg, tcfg = _configs()
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, bridge.params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _prompts(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


# ---------------------------------------------------------------------------
# the selective scan
# ---------------------------------------------------------------------------


def _scan_inputs(seed, b, s, di, n):
    """numpy f32 xm, dt (softplus-range, > 0), Bm, Cm, A (< 0), D and a
    non-zero initial state."""
    rng = np.random.default_rng(seed)
    xm = rng.standard_normal((b, s, di))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)) - 3.0))
    bm, cm = rng.standard_normal((2, b, s, n))
    a = -np.exp(0.5 * rng.standard_normal((di, n)))
    d = rng.standard_normal(di)
    st = 0.3 * rng.standard_normal((b, di, n))
    return [np.asarray(v, np.float32) for v in (xm, dt, bm, cm, a, d, st)]


SCANS = [(2, 24, 16, 4, 8), (1, 64, 32, 16, 16), (3, 5, 8, 2, 5)]


@pytest.mark.parametrize("b,s,di,n,chunk", SCANS)
def test_selective_scan_matches_jax(b, s, di, n, chunk):
    inputs = _scan_inputs(1, b, s, di, n)
    jy, js = jax.jit(jax_hybrid.selective_scan)(*map(jnp.asarray, inputs))
    ty, ts = port_hybrid.selective_scan(*map(_t, inputs))
    assert ty.dtype == torch.float32 and ts.dtype == torch.float32
    _close(ty, jy, STEP_TOL)
    _close(ts, js, STEP_TOL)


@pytest.mark.parametrize("b,s,di,n,chunk", SCANS)
def test_selective_scan_chunked_matches_jax_and_the_step_scan(b, s, di, n,
                                                              chunk):
    inputs = _scan_inputs(2, b, s, di, n)
    jy, js = jax.jit(functools.partial(jax_hybrid.selective_scan_chunked,
                                       chunk=chunk))(*map(jnp.asarray, inputs))
    ty, ts = port_hybrid.selective_scan_chunked(*map(_t, inputs), chunk=chunk)
    _close(ty, jy, STEP_TOL)
    _close(ts, js, STEP_TOL)
    sy, ss = port_hybrid.selective_scan(*map(_t, inputs))
    torch.testing.assert_close(ty, sy, **STEP_TOL)
    torch.testing.assert_close(ts, ss, **STEP_TOL)


def test_selective_scan_chunked_rejects_a_ragged_sequence():
    inputs = _scan_inputs(3, 1, 12, 4, 2)
    with pytest.raises(ValueError, match="divisible"):
        port_hybrid.selective_scan_chunked(*map(_t, inputs), chunk=8)


def test_softplus_matches_jax():
    """logaddexp(x, 0), on both sides of F.softplus's threshold of 20."""
    x = np.concatenate([np.linspace(-40, 40, 161),
                        [0.0, 19.9, 20.0, 20.1, 88.0]]).astype(np.float32)
    got = port_hybrid.softplus(_t(x))
    _close(got, jax.nn.softplus(jnp.asarray(x)), dict(atol=0, rtol=1e-6))


def test_head_split_matches_jax():
    for cfg_j, cfg_t in ((jax_config(ARCH), port_config(ARCH)), _configs()):
        assert port_hybrid.head_split(cfg_t) == jax_hybrid.head_split(cfg_j)
    assert port_hybrid.head_split(port_config(ARCH)) == (10, 15)


# ---------------------------------------------------------------------------
# block and model
# ---------------------------------------------------------------------------


def test_block_with_a_cache_matches_jax(pair):
    """One layer over an 11-token prefill that builds the cache (ring KV
    and the scan state), then one decode token against it: outputs and
    the cache, which the port updates in place."""
    jcfg, jp, tcfg, tp = pair
    jl = {k: v[1] for k, v in jp["blocks"].items()}
    tl = {k: v[1] for k, v in tp["blocks"].items()}
    x = np.random.default_rng(7).standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32)
    S = 11
    pos = np.broadcast_to(np.arange(S), (2, S))
    block = jax.jit(jax_hybrid.hybrid_block_apply, static_argnums=(0,),
                    static_argnames=("build_cache_w",))
    jy, jc, _ = block(jcfg, jl, jnp.asarray(x[:, :S]), jnp.asarray(pos),
                      jax_model(jcfg)._mask(S, S), build_cache_w=16)
    ty, tc = port_hybrid.hybrid_block_apply(
        tcfg, tl, _t(x[:, :S]), _t(pos), build_cache_w=16)
    _close(ty, jy, STEP_TOL)
    assert set(tc) == set(jc) == {"k", "v", "ssm_state"}
    assert tc["ssm_state"].dtype == torch.float32
    for key in jc:
        _close(tc[key], jc[key], STEP_TOL)
    dpos = np.array([S, S], np.int32)
    jy, jc, _ = block(jcfg, jl, jnp.asarray(x[:, S:]),
                      jnp.asarray(dpos[:, None]), None, cache=jc,
                      pos=jnp.asarray(dpos))
    state = tc["ssm_state"]
    ty, out = port_hybrid.hybrid_block_apply(
        tcfg, tl, _t(x[:, S:]), _t(dpos[:, None].astype(np.int64)),
        cache=tc, pos=_t(dpos))
    assert out is tc and tc["ssm_state"] is state
    _close(ty, jy, STEP_TOL)
    for key in jc:
        _close(tc[key], jc[key], STEP_TOL)


def test_forward_matches_jax(pair):
    """Full-sequence logits within 1e-4 over 80 tokens (past the window);
    the aux loss is 0, as in JAX."""
    jcfg, jp, tcfg, tp = pair
    toks = _prompts(jcfg, 2, 80, seed=1)
    jl, jaux = jax.jit(jax_model(jcfg).forward)(jp, jnp.asarray(toks))
    tl, taux = port_model(tcfg).forward(tp, torch.from_numpy(toks))
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0


def test_prefill_and_decode_match_jax_forward(pair):
    """A 70-token prompt (windowed prefill), then 10 teacher-forced decode
    steps on the wrapped ring against JAX's full-sequence logits, and the
    caches against JAX's prefill."""
    jcfg, jp, tcfg, tp = pair
    jm, tm = jax_model(jcfg), port_model(tcfg)
    toks = _prompts(jcfg, 2, 80, seed=2)
    full, _ = jax.jit(jm.forward)(jp, jnp.asarray(toks))
    _, jc, _ = jax.jit(jm.prefill, static_argnames=("max_len",))(
        jp, jnp.asarray(toks[:, :70]), max_len=MAX_LEN)
    last, tc, _ = tm.prefill(tp, torch.from_numpy(toks[:, :70]), MAX_LEN)
    _close(last, full[:, 69])
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key], jc[key])
    for i in range(70, 80):
        logits, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i]), i)
        _close(logits, full[:, i])


def test_chunked_scan_prefill_matches_jax():
    """scan_impl="chunked": a 64-token prefill through the chunked scan
    (chunk 16), logits and the scan state against JAX's."""
    jcfg, tcfg = _configs("chunked")
    jp = jax_model(jcfg).init(jax.random.PRNGKey(2))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    toks = _prompts(jcfg, 2, 64, seed=3)
    jl, jc, _ = jax.jit(jax_model(jcfg).prefill,
                        static_argnames=("max_len",))(
        jp, jnp.asarray(toks), max_len=MAX_LEN)
    tl, tc, _ = port_model(tcfg).prefill(tp, torch.from_numpy(toks), MAX_LEN)
    _close(tl, jl)
    _close(tc["ssm_state"], jc["ssm_state"])


def test_plain_path_matches_kernel_path(pair):
    _, _, tcfg, tp = pair
    toks = torch.from_numpy(_prompts(tcfg, 2, 9, seed=4))
    a = port_model(tcfg).prefill(tp, toks, MAX_LEN)
    b = port_model(tcfg, plain=True).prefill(tp, toks, MAX_LEN)
    torch.testing.assert_close(a[0], b[0], **TOL)
    torch.testing.assert_close(a[1]["ssm_state"], b[1]["ssm_state"], **TOL)


def test_init_cache_matches_jax():
    jcfg, tcfg = _configs()
    want = jax_model(jcfg).init_cache(3, MAX_LEN)
    cache = port_model(tcfg).init_cache(3, MAX_LEN, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in cache.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    assert all(int(v.count_nonzero()) == 0 for v in cache.values())


# ---------------------------------------------------------------------------
# the engine and the scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 8])
def test_engine_tokens_equal_jax_engine(pair, chunk):
    """Prompts of 60 tokens and 11 new ones: the ring wraps in decode."""
    jcfg, jp, tcfg, tp = pair
    toks = _prompts(jcfg, 2, 60, seed=2)
    want = np.asarray(JaxEngine(jcfg, jp, max_len=MAX_LEN, decode_chunk=chunk)
                      .generate(jnp.asarray(toks), max_new_tokens=11))
    got = InferenceEngine(tcfg, tp, max_len=MAX_LEN, decode_chunk=chunk,
                          device="cpu").generate(toks, max_new_tokens=11)
    np.testing.assert_array_equal(got.numpy(), want)


def _trace(module, cfg):
    """Ragged: 4 requests on 2 slots, staggered arrivals, one prompt past
    the window, an emulated early EOS."""
    rng = np.random.default_rng(0)
    spec = [(7, 6, 0.0, None), (70, 5, 0.0, None), (5, 7, 0.5, 3),
            (9, 3, 1.0, None)]
    return [module.Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, s),
                           max_new_tokens=n, arrival=a, eos_pos=eos)
            for i, (s, n, a, eos) in enumerate(spec)]


def test_ragged_scheduler_equals_jax_scheduler(pair):
    """The contiguous Scheduler (``make_backend("gspmd")``) over a ragged
    trace: streams, step records and finish reasons equal JAX's."""
    jcfg, jp, tcfg, tp = pair
    jb = jax_backends.make_backend("gspmd", jcfg, jp, num_slots=2,
                                   max_len=MAX_LEN)
    want = jax_scheduler.Scheduler(
        jb, clock=jax_scheduler.VirtualClock()).run(_trace(jax_request, jcfg))
    tb = make_backend("gspmd", tcfg, tp, num_slots=2, max_len=MAX_LEN,
                      device="cpu")
    got = port_scheduler.Scheduler(
        tb, clock=port_scheduler.VirtualClock()).run(
        _trace(port_request, tcfg))
    assert got.tokens_by_rid() == want.tokens_by_rid()
    assert [(r.phase, r.n_active, r.rid) for r in got.steps] == \
        [(r.phase, r.n_active, r.rid) for r in want.steps]
    assert [m.finish_reason for m in got.metrics] == \
        [m.finish_reason for m in want.metrics]


# ---------------------------------------------------------------------------
# weights, init, and what the family does not take
# ---------------------------------------------------------------------------


def test_port_init_follows_the_jax_rule():
    _, tcfg = _configs()
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    params = port_model(tcfg).init(seed=0, device="cpu")
    shapes = bridge.expected_shapes(tcfg)
    blocks = params["blocks"]
    assert blocks.keys() == shapes["blocks"].keys()
    for key, shape in shapes["blocks"].items():
        assert tuple(blocks[key].shape) == shape, key
        assert blocks[key].dtype == bridge.expected_dtype(tcfg, key), key
    for key in ("b_dt", "A_log", "D"):
        assert blocks[key].dtype == torch.float32
    assert bool((blocks["b_dt"] == -4.0).all())
    assert blocks["A_log"].abs().sum() == 0
    assert bool((blocks["D"] == 1.0).all())
    for key in ("ln1", "ln2", "ln_attn", "ln_ssm"):
        assert blocks[key].abs().sum() == 0
    std = float(blocks["in_proj"].float().std())
    assert abs(std * np.sqrt(tcfg.d_model) - 1.0) < 0.05
    std = float(blocks["w_dt"].float().std())       # scale 0.01, as in JAX
    assert abs(std / 0.01 - 1.0) < 0.05


def test_paged_tp_and_pp_reject_the_hybrid_family():
    _, tcfg = _configs()
    params = port_model(tcfg).init(seed=0, device="cpu")
    with pytest.raises(ValueError, match="paged mode covers dense"):
        make_backend("gspmd", tcfg, params, num_slots=2, paged=True,
                     device="cpu")
    with pytest.raises(ValueError, match="explicit TP engine covers the "
                                         "dense family"):
        make_backend("tp", tcfg, params, num_slots=2, t=2, device="cpu")
    with pytest.raises(ValueError, match="PipelineEngine covers the dense "
                                         "family"):
        make_backend("pp", tcfg, params, num_slots=2, p=2, device="cpu")
