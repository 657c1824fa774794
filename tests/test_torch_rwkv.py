"""The port's RWKV-6 family against the JAX package.

The WKV recurrence (plain version and chunked form), the ssm block, the
model, the engine and the contiguous Scheduler are held to the JAX
package on the CPU, with inputs made by numpy from a seed and weights
carried across through numpy (``repro_torch.bridge``).  On the CPU the
port's B10 wrapper runs its plain version; the CUDA kernel is held to
that version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: float32 results agree to 1e-5 (recurrence) and 1e-4 (whole
model) absolute and relative — the two frameworks sum the same f32
products in another order (observed ~1e-6); a bf16 output rounds an f32
result once on each side, so the two may land one bf16 ulp apart (2^-8
relative): 2e-2.  Greedy tokens must be identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels.rwkv6_scan.chunked import \
    wkv6_chunked as jax_chunked  # noqa: E402
from repro.kernels.rwkv6_scan.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro.kernels.rwkv6_scan.wkv6_kernel import wkv6_pallas  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro.runtime.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.kernels.rwkv6_scan.chunked import wkv6_chunked  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import wkv6  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref  # noqa: E402
from repro_torch.models import ssm as port_ssm  # noqa: E402
from repro_torch.models.layers import torch_dtype  # noqa: E402
from repro_torch.models.transformer import get_model as port_model  # noqa: E402
from repro_torch.runtime import request as port_request  # noqa: E402
from repro_torch.runtime import scheduler as port_scheduler  # noqa: E402
from repro_torch.runtime.backends import make_backend  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402

ARCH = "rwkv6-7b"
SCAN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 48
# the JAX package's kernel sweep (tests/test_kernels.py): b, s, h, hs, chunk
SWEEP = [(2, 64, 3, 32, 16), (1, 128, 2, 64, 128), (3, 32, 1, 16, 8)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_to_torch(a):
    return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)


def _scan_inputs(seed, b, s, h, hs, dtype, w_low=0.8):
    """numpy f32 r, k, v, w [b,s,h,hs], u [h,hs], state [b,h,hs,hs] (a
    non-zero initial state); r/k/v/w rounded to ``dtype`` by JAX."""
    rng = np.random.default_rng(seed)
    rkv = [0.5 * rng.standard_normal((b, s, h, hs)) for _ in range(3)]
    w = rng.uniform(w_low, 0.999, (b, s, h, hs))
    u = (0.3 * rng.standard_normal((h, hs))).astype(np.float32)
    st = (0.1 * rng.standard_normal((b, h, hs, hs))).astype(np.float32)
    jx = [jnp.asarray(a, dtype) for a in (*rkv, w)]
    return jx, jnp.asarray(u), jnp.asarray(st)


def _port(jx):
    return [_bf16_to_torch(a) if a.dtype == jnp.bfloat16 else _t(a)
            for a in jx]


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# the recurrence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,hs,chunk", SWEEP)
def test_wkv6_ref_matches_jax_ref_and_pallas(dtype, b, s, h, hs, chunk):
    jx, u, st = _scan_inputs(4, b, s, h, hs, jnp.dtype(dtype))
    y, state = wkv6_ref(*_port(jx), _t(u), _t(st))
    assert y.dtype == torch_dtype(dtype) and state.dtype == torch.float32
    for want_y, want_s in (jax_wkv6_ref(*jx, u, st),
                           wkv6_pallas(*jx, u, st, chunk=chunk,
                                       interpret=True)):
        _close(y, want_y, SCAN_TOL[dtype])
        # the state is f32 on both sides from the same rounded inputs
        _close(state, want_s, SCAN_TOL["float32"])


@pytest.mark.parametrize("b,s,h,hs,chunk,w_low", [
    (2, 64, 3, 32, 16, 0.8), (1, 48, 2, 16, 8, 0.01), (1, 5, 1, 64, 16, 0.5)])
def test_wkv6_chunked_matches_jax(b, s, h, hs, chunk, w_low):
    """Fast-decay channels (w down to 0.01) included; chunk > S clips to
    S, as in JAX."""
    jx, u, st = _scan_inputs(5, b, s, h, hs, jnp.float32, w_low)
    y, state = wkv6_chunked(*_port(jx), _t(u), _t(st), chunk=chunk)
    want_y, want_s = jax_chunked(*jx, u, st, chunk=chunk)
    _close(y, want_y, SCAN_TOL["float32"])
    _close(state, want_s, SCAN_TOL["float32"])


def test_wkv6_chunked_rejects_a_ragged_sequence():
    r = torch.zeros(1, 12, 1, 16)
    with pytest.raises(ValueError, match="divisible"):
        wkv6_chunked(r, r, r, r, torch.zeros(1, 16), torch.zeros(1, 1, 16, 16),
                     chunk=8)


def test_wkv6_dispatch_writes_the_state_in_place():
    jx, u, st = _scan_inputs(6, 2, 3, 2, 16, jnp.float32)
    inputs = _port(jx)
    want_y, want_s = wkv6_ref(*inputs, _t(u), _t(st))
    state = _t(st)
    y, out = wkv6(*inputs, _t(u), state, state_out=state)
    assert out is state
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(state, want_s, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# block, model, engine, scheduler
# ---------------------------------------------------------------------------


def _configs(scan_impl="step"):
    jcfg, tcfg = jax_config(ARCH).reduced(), port_config(ARCH).reduced()
    if scan_impl != "step":
        jcfg, tcfg = (dataclasses.replace(c, ssm=dataclasses.replace(
            c.ssm, scan_impl=scan_impl, scan_chunk=8)) for c in (jcfg, tcfg))
    return jcfg, tcfg


@pytest.fixture(scope="module", params=["step", "chunked"])
def pair(request):
    """(jax cfg, jax params, port cfg, port params) with equal weights."""
    jcfg, tcfg = _configs(request.param)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, bridge.params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _prompts(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (b, s)).astype(np.int32)


def _close_cache(port, ref):
    assert set(port) == set(ref) == {"state", "tm_prev", "cm_prev"}
    for key in ref:
        assert tuple(port[key].shape) == ref[key].shape
        np.testing.assert_allclose(port[key].numpy(), np.asarray(ref[key]),
                                   **TOL)


def test_block_with_a_cache_matches_jax(pair):
    """One layer over a 5-token chunk on a non-zero cache (and then one
    token): outputs and the cache the port updates in place."""
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(7)
    h, H, hs = tcfg.d_model, tcfg.num_heads, tcfg.ssm.head_size
    x = rng.standard_normal((2, 5, h)).astype(np.float32)
    cache = {"state": 0.1 * rng.standard_normal((2, H, hs, hs)),
             "tm_prev": rng.standard_normal((2, h)),
             "cm_prev": rng.standard_normal((2, h))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    jl = {k: v[0] for k, v in jp["blocks"].items()}
    tl = {k: v[0] for k, v in tp["blocks"].items()}
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    tc = {k: _t(v) for k, v in cache.items()}
    for xs in (x, x[:, :1]):
        jy, jc, _ = jax_ssm.ssm_block_apply(jcfg, jl, jnp.asarray(xs), None,
                                            None, cache=jc)
        ty, out = port_ssm.ssm_block_apply(tcfg, tl, _t(xs), None, cache=tc)
        assert out is tc
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        _close_cache(tc, jc)


def test_prefill_and_decode_match(pair):
    jcfg, jp, tcfg, tp = pair
    jm, tm = jax_model(jcfg), port_model(tcfg)
    toks = _prompts(jcfg, 2, 16)
    jl, jc, _ = jm.prefill(jp, jnp.asarray(toks), max_len=MAX_LEN)
    tl, tc, S = tm.prefill(tp, torch.from_numpy(toks), MAX_LEN)
    assert S == 16
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(tc, jc)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    # scalar pos (fixed batch), then [B] pos (continuous batching)
    for pos in (16, np.array([17, 17], np.int32)):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                torch.as_tensor(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _close_cache(tc, jc)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)


def test_plain_path_matches_kernel_path(pair):
    """The model's two paths (kernel wrappers vs plain versions) agree — on
    the CPU the wrappers run the plain versions."""
    _, _, tcfg, tp = pair
    toks = torch.from_numpy(_prompts(tcfg, 2, 9, seed=4))
    a = port_model(tcfg).prefill(tp, toks, MAX_LEN)
    b = port_model(tcfg, plain=True).prefill(tp, toks, MAX_LEN)
    torch.testing.assert_close(a[0], b[0], **TOL)
    torch.testing.assert_close(a[1]["state"], b[1]["state"], **TOL)


@pytest.mark.parametrize("chunk", [1, 8])
def test_engine_tokens_equal_jax_engine(pair, chunk):
    jcfg, jp, tcfg, tp = pair
    toks = _prompts(jcfg, 2, 16, seed=2)
    want = np.asarray(JaxEngine(jcfg, jp, max_len=MAX_LEN, decode_chunk=chunk)
                      .generate(jnp.asarray(toks), max_new_tokens=13))
    got = InferenceEngine(tcfg, tp, max_len=MAX_LEN, decode_chunk=chunk,
                          device="cpu").generate(toks, max_new_tokens=13)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ragged_scheduler_equals_jax_solo_streams(pair):
    """The contiguous Scheduler over ragged requests (staggered arrivals,
    slot reuse) gives each request the tokens the JAX engine gives it
    served alone."""
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(0)
    spec = [(6, 5, 0.0), (16, 4, 0.0), (4, 6, 0.0), (9, 3, 1.0)]
    reqs = [port_request.Request(
        rid=i, prompt=rng.integers(2, tcfg.vocab_size, s).astype(np.int32),
        max_new_tokens=n, arrival=a) for i, (s, n, a) in enumerate(spec)]
    solo = {r.rid: np.asarray(JaxEngine(jcfg, jp, max_len=MAX_LEN,
                                        decode_chunk=1).generate(
        jnp.asarray(r.prompt)[None, :], max_new_tokens=r.max_new_tokens))[0]
        .tolist() for r in reqs}
    backend = make_backend("gspmd", tcfg, tp, num_slots=2, max_len=MAX_LEN,
                           device="cpu")
    report = port_scheduler.Scheduler(
        backend, clock=port_scheduler.VirtualClock()).run(reqs)
    assert report.tokens_by_rid() == solo


def test_init_cache_is_constant_in_max_len():
    jcfg, tcfg = _configs()
    tm = port_model(tcfg)
    want = jax_model(jcfg).init_cache(3, 16)
    for max_len in (16, 4096):
        cache = tm.init_cache(3, max_len, device="cpu")
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in cache.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in want.items()}
        assert all(int(v.count_nonzero()) == 0 for v in cache.values())


# ---------------------------------------------------------------------------
# weights, init, and what the family does not take
# ---------------------------------------------------------------------------


def test_bridge_keeps_f32_leaves_in_bf16_and_round_trips_bitwise():
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in _configs())
    np_params = jax.tree.map(np.asarray,
                             jax_model(jcfg).init(jax.random.PRNGKey(3)))
    params = bridge.params_from_jax(np_params, tcfg, device="cpu")
    assert len(params["blocks"]) == 22
    for key, val in params["blocks"].items():
        want = torch.float32 if key in ("w0", "u") else torch.bfloat16
        assert val.dtype == want, key
    back = bridge.params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(np_params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), path
    np_params["blocks"]["u"] = np_params["blocks"]["u"].astype(
        np_params["blocks"]["wr"].dtype)
    with pytest.raises(ValueError, match="u:"):
        bridge.params_from_jax(np_params, tcfg, device="cpu")


def test_port_init_follows_the_jax_rule():
    _, tcfg = _configs()
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    params = port_model(tcfg).init(seed=0, device="cpu")
    shapes = bridge.expected_shapes(tcfg)
    assert params["blocks"].keys() == shapes["blocks"].keys()
    for key, shape in shapes["blocks"].items():
        t = params["blocks"][key]
        assert tuple(t.shape) == shape
        assert t.dtype == bridge.expected_dtype(tcfg, key)
    blocks = params["blocks"]
    assert blocks["ln1"].abs().sum() == 0 and blocks["ln_x"].abs().sum() == 0
    assert bool((blocks["mx_r"] == 0.5).all())
    assert bool((blocks["w0"] == -2.0).all())
    std = float(blocks["wr"].float().std())
    assert abs(std * np.sqrt(tcfg.d_model) - 1.0) < 0.05
    assert abs(float(blocks["u"].std()) - 0.5) < 0.05
    again = port_model(tcfg).init(seed=0, device="cpu")
    assert torch.equal(blocks["cwv"], again["blocks"]["cwv"])


def test_paged_mode_and_tp_reject_the_ssm_family():
    _, tcfg = _configs()
    params = port_model(tcfg).init(seed=0, device="cpu")
    with pytest.raises(ValueError, match="dense"):
        make_backend("gspmd", tcfg, params, num_slots=2, paged=True,
                     device="cpu")
    with pytest.raises(ValueError, match="dense"):
        port_model(tcfg).init_paged_cache(4, 4, device="cpu")
    with pytest.raises(ValueError, match="dense"):
        make_backend("tp", tcfg, params, num_slots=2, t=2, device="cpu")
