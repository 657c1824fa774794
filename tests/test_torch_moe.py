"""The port's MoE family (deepseek-moe-16b, mixtral-8x22b) against the JAX
package.

The routed-expert computation (router, top-k, the capacity-bounded sorted
dispatch, the stacked expert GLU and the combine), the block, the model,
the engine and the contiguous Scheduler are held to the JAX package on the
CPU at reduced width in f32, with weights carried across through numpy
(``repro_torch.bridge``) and inputs made by numpy from a seed.  The
reduced configs are dropless (capacity factor = E); the cases with
``capacity_factor=1.0`` drop pairs, and the port must drop the same ones.
mixtral's reduced window is 64, so its 80-token prompts run the windowed
prefill and wrap the ring cache.  On the CPU the attention and norm
wrappers run their plain versions; the kernels are held to those on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: 1e-5 absolute and relative for one layer's experts and one
block, 1e-4 for whole-model logits — the two frameworks sum the same f32
products in another order (observed ~4e-6).  Greedy tokens and streams
must be identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro.runtime import backends as jax_backends  # noqa: E402
from repro.runtime import request as jax_request  # noqa: E402
from repro.runtime import scheduler as jax_scheduler  # noqa: E402
from repro.runtime.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.models.transformer import get_model as port_model  # noqa: E402
from repro_torch.runtime import request as port_request  # noqa: E402
from repro_torch.runtime import scheduler as port_scheduler  # noqa: E402
from repro_torch.runtime.backends import make_backend  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402

ARCHS = ("deepseek-moe-16b", "mixtral-8x22b")
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 96


def _configs(arch, capacity_factor=None):
    jcfg, tcfg = jax_config(arch).reduced(), port_config(arch).reduced()
    if capacity_factor is not None:
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (jcfg, tcfg))
    return jcfg, tcfg


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax params, port cfg, port params) with equal weights."""
    jcfg, tcfg = _configs(request.param)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, bridge.params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _layer(params, layer=0):
    return {k: v[layer] for k, v in params["blocks"].items()}


def _prompts(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


# ---------------------------------------------------------------------------
# the routed experts
# ---------------------------------------------------------------------------


def _jax_kept(jcfg, router, xf, cap):
    """{(token, expert)} that JAX's ``_moe_compute`` keeps: its own
    routing, stable sort by expert and capacity test, restated."""
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


@pytest.mark.parametrize("arch,cf,tokens", [
    ("deepseek-moe-16b", None, 40), ("deepseek-moe-16b", 1.0, 40),
    ("mixtral-8x22b", 1.0, 33)], ids=["deepseek-dropless", "deepseek-drops",
                                      "mixtral-drops"])
def test_moe_compute_matches_jax(arch, cf, tokens):
    """One layer's routed experts on tokens xf [T, h]: y and the aux loss
    within 1e-5, and with capacity_factor 1.0 the same (token, expert)
    pairs kept (and some dropped)."""
    jcfg, tcfg = _configs(arch, cf)
    jl = _layer(jax_model(jcfg).init(jax.random.PRNGKey(1)))
    tl = {k: torch.from_numpy(np.array(v)) for k, v in jl.items()}
    xf = np.random.default_rng(3).standard_normal(
        (tokens, jcfg.d_model)).astype(np.float32)
    cap = jax_moe.moe_capacity(tokens, jcfg)
    assert port_moe.moe_capacity(tokens, tcfg) == cap
    jy, jaux = jax.jit(jax_moe._moe_compute, static_argnums=(0, 3))(
        jcfg, jl, jnp.asarray(xf), cap)
    ty, taux = port_moe._moe_compute(tcfg, tl, torch.from_numpy(xf), cap)
    _close(ty, jy, STEP_TOL)
    _close(taux, jaux, STEP_TOL)

    _, top_i, _ = port_moe.route(tcfg, tl["router"], torch.from_numpy(xf))
    top_i, _ = torch.sort(top_i, dim=-1)
    keep = port_moe.dispatch_plan(top_i, tcfg.moe.num_experts, cap)[3]
    kept = {(t, int(top_i[t, k])) for t, k in keep.nonzero().tolist()}
    assert kept == _jax_kept(jcfg, jl["router"], jnp.asarray(xf), cap)
    assert (len(kept) < tokens * tcfg.moe.top_k) == (cf is not None)


def test_moe_capacity_matches_jax():
    for arch in ARCHS:
        for cf in (None, 1.0, 1.25):
            jcfg, tcfg = _configs(arch, cf)
            for tokens in (1, 4, 7, 128, 1500):
                assert port_moe.moe_capacity(tokens, tcfg) == \
                    jax_moe.moe_capacity(tokens, jcfg)
    full = port_config("deepseek-moe-16b")
    assert port_moe.moe_capacity(4, full) == 6      # a 4-slot decode step


def test_block_with_a_cache_matches_jax(pair):
    """One layer over an 11-token prefill that builds the ring cache, then
    one decode token against it: outputs, aux and the cache, which the
    port updates in place."""
    jcfg, jp, tcfg, tp = pair
    jl, tl = _layer(jp, 1), _layer(tp, 1)
    x = np.random.default_rng(7).standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32)
    S = 11
    pos = np.broadcast_to(np.arange(S), (2, S))
    mask = jax_model(jcfg)._mask(S, S)
    block = jax.jit(jax_moe.moe_block_apply, static_argnums=(0,),
                    static_argnames=("build_cache_w",))
    jy, jc, jaux = block(jcfg, jl, jnp.asarray(x[:, :S]), jnp.asarray(pos),
                         mask, build_cache_w=16)
    auxes = []
    ty, tc = port_moe.moe_block_apply(
        tcfg, tl, torch.from_numpy(x[:, :S]), torch.from_numpy(pos.copy()),
        build_cache_w=16, aux_out=auxes)
    _close(ty, jy, STEP_TOL)
    _close(auxes[0], jaux, STEP_TOL)
    for key in ("k", "v"):
        _close(tc[key], jc[key], STEP_TOL)
    dpos = np.array([S, S], np.int32)
    jy, jc, _ = block(jcfg, jl, jnp.asarray(x[:, S:]),
                      jnp.asarray(dpos[:, None]), None, cache=jc,
                      pos=jnp.asarray(dpos))
    ty, out = port_moe.moe_block_apply(
        tcfg, tl, torch.from_numpy(x[:, S:]),
        torch.from_numpy(dpos[:, None].astype(np.int64)), cache=tc,
        pos=torch.from_numpy(dpos))
    assert out["k"] is tc["k"]
    _close(ty, jy, STEP_TOL)
    for key in ("k", "v"):
        _close(tc[key], jc[key], STEP_TOL)


# ---------------------------------------------------------------------------
# the model, the engine, the scheduler
# ---------------------------------------------------------------------------


def test_forward_matches_jax(pair):
    """Full-sequence logits within 1e-4 and the aux loss summed over
    layers (an 80-token sequence, past mixtral's reduced window)."""
    jcfg, jp, tcfg, tp = pair
    toks = _prompts(jcfg, 2, 80, seed=1)
    jl, jaux = jax.jit(jax_model(jcfg).forward)(jp, jnp.asarray(toks))
    tl, taux = port_model(tcfg).forward(tp, torch.from_numpy(toks))
    assert tuple(tl.shape) == (2, 80, tcfg.padded_vocab)
    _close(tl, jl)
    _close(taux, jaux, STEP_TOL)
    assert float(taux) > 0


def test_prefill_and_decode_match_jax_forward(pair):
    """Prefill 70 tokens, decode 10 teacher-forced against JAX's
    full-sequence logits (test_smoke_archs' check), the caches against
    JAX's prefill; on mixtral the window is 64, so the prefill is windowed
    and decode runs on a wrapped ring."""
    jcfg, jp, tcfg, tp = pair
    jm, tm = jax_model(jcfg), port_model(tcfg)
    toks = _prompts(jcfg, 2, 80, seed=2)
    full, _ = jax.jit(jm.forward)(jp, jnp.asarray(toks))
    _, jc, _ = jax.jit(jm.prefill, static_argnames=("max_len",))(
        jp, jnp.asarray(toks[:, :70]), max_len=MAX_LEN)
    last, tc, S = tm.prefill(tp, torch.from_numpy(toks[:, :70]), MAX_LEN)
    assert S == 70
    _close(last, full[:, 69])
    assert set(tc) == {"k", "v"}
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key], jc[key])
    for i in range(70, 80):
        logits, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i]), i)
        _close(logits, full[:, i])


def test_plain_path_matches_kernel_path(pair):
    """The model's two paths agree — on the CPU the wrappers run the
    plain versions."""
    _, _, tcfg, tp = pair
    toks = torch.from_numpy(_prompts(tcfg, 2, 9, seed=4))
    a = port_model(tcfg).prefill(tp, toks, MAX_LEN)
    b = port_model(tcfg, plain=True).prefill(tp, toks, MAX_LEN)
    torch.testing.assert_close(a[0], b[0], **TOL)
    torch.testing.assert_close(a[1]["k"], b[1]["k"], **TOL)


@pytest.mark.parametrize("chunk", [1, 8])
def test_engine_tokens_equal_jax_engine(pair, chunk):
    jcfg, jp, tcfg, tp = pair
    toks = _prompts(jcfg, 2, 16, seed=2)
    want = np.asarray(JaxEngine(jcfg, jp, max_len=MAX_LEN, decode_chunk=chunk)
                      .generate(jnp.asarray(toks), max_new_tokens=11))
    got = InferenceEngine(tcfg, tp, max_len=MAX_LEN, decode_chunk=chunk,
                          device="cpu").generate(toks, max_new_tokens=11)
    np.testing.assert_array_equal(got.numpy(), want)


def _trace(module, cfg):
    """Ragged: 4 requests on 2 slots, staggered arrivals (queueing,
    mid-decode admission, slot reuse, an emulated early EOS)."""
    rng = np.random.default_rng(0)
    spec = [(7, 6, 0.0, None), (12, 4, 0.0, None), (5, 7, 0.5, 3),
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
    """Seeded init: the JAX package's shapes and types (the router f32),
    zero norms, normal / sqrt(fan_in) for every expert of every layer (the
    [L, E, h, f] stacks are drawn a layer at a time)."""
    tcfg = dataclasses.replace(port_config("deepseek-moe-16b").reduced(
        num_layers=3), dtype="bfloat16")
    params = port_model(tcfg).init(seed=0, device="cpu")
    shapes = bridge.expected_shapes(tcfg)
    blocks = params["blocks"]
    assert blocks.keys() == shapes["blocks"].keys()
    for key, shape in shapes["blocks"].items():
        assert tuple(blocks[key].shape) == shape, key
        assert blocks[key].dtype == bridge.expected_dtype(tcfg, key), key
    assert blocks["router"].dtype == torch.float32
    assert blocks["ln1"].abs().sum() == 0 and blocks["ln2"].abs().sum() == 0
    h, f = tcfg.d_model, tcfg.moe.expert_d_ff
    for key, fan_in in (("we1", h), ("we2", f), ("we3", h), ("sw1", h)):
        for layer in blocks[key]:
            std = float(layer.float().std())
            assert abs(std * np.sqrt(fan_in) - 1.0) < 0.05, key
    # layers are separate draws
    assert not torch.equal(blocks["we1"][0], blocks["we1"][1])
    again = port_model(tcfg).init(seed=0, device="cpu")
    assert torch.equal(blocks["we2"], again["blocks"]["we2"])


def test_paged_tp_and_pp_reject_the_moe_family():
    _, tcfg = _configs("deepseek-moe-16b")
    params = port_model(tcfg).init(seed=0, device="cpu")
    with pytest.raises(ValueError, match="paged mode covers dense"):
        make_backend("gspmd", tcfg, params, num_slots=2, paged=True,
                     device="cpu")
    with pytest.raises(ValueError, match="dense"):
        port_model(tcfg).init_paged_cache(4, 4, device="cpu")
    with pytest.raises(ValueError, match="explicit TP engine covers the "
                                         "dense family"):
        make_backend("tp", tcfg, params, num_slots=2, t=2, device="cpu")
    with pytest.raises(ValueError, match="PipelineEngine covers the dense "
                                         "family"):
        make_backend("pp", tcfg, params, num_slots=2, p=2, device="cpu")


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "hymba-1.5b"])
def test_entry_points_need_a_card_unless_asked_for_cpu(arch):
    """The moe and hybrid families run on the card by default, as the dense
    family does: without one, every entry point raises unless the caller
    asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    tcfg = port_config(arch).reduced()
    params = port_model(tcfg).init(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_model(tcfg).init(seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(tcfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_backend("gspmd", tcfg, params, num_slots=2)
    InferenceEngine(tcfg, params, device="cpu")
    make_backend("gspmd", tcfg, params, num_slots=2, device="cpu")
