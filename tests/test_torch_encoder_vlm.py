"""The port's encoder (hubert-xlarge) and vlm (paligemma-3b) families
against the JAX package.

The two masks these families add to the causal one — the encoder's
bidirectional mask and the vlm's prefix mask (the image prefix visible to
every position, the text causal) — are held to JAX's ``make_mask``, and
B2's plain version in every mode to JAX's ``gqa_attention`` on that mask,
at head dims 64, 80 (hubert) and 256 (paligemma).  Then the models at
reduced width in f32, with weights carried across through numpy
(``repro_torch.bridge``) and inputs made by numpy from a seed: hubert's
``forward(features=)`` and ``InferenceEngine.encode``, paligemma's
``forward(prefix_emb=)``, its prefill and decode against its own forward,
``generate(prefix_emb=)`` tokens against JAX's engine, and its text
requests through the contiguous Scheduler against JAX's.  The model
checks run again at head dims 80 and 256 (``dataclasses.replace`` on both
sides), so the plain path runs the kernels' new head dims.  On the CPU
the attention and norm wrappers run their plain versions; the kernels are
held to those on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances: hubert's logits 1e-5 absolute and relative (observed ~3e-6);
paligemma's 1e-4 relative to the logits' scale — the embedding is scaled
by sqrt(h) = 16 and tied to the head, so logits reach ~30 and one f32
ulp of them is ~2e-6 (observed ~9e-5 absolute); masks and the attention
refs 1e-5 (the two frameworks sum the same f32 products in another
order).  Greedy tokens and streams must be identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.transformer import get_model as jax_model  # noqa: E402
from repro.runtime import backends as jax_backends  # noqa: E402
from repro.runtime import request as jax_request  # noqa: E402
from repro.runtime import scheduler as jax_scheduler  # noqa: E402
from repro.runtime.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models.transformer import get_model as port_model  # noqa: E402
from repro_torch.runtime import request as port_request  # noqa: E402
from repro_torch.runtime import scheduler as port_scheduler  # noqa: E402
from repro_torch.runtime.backends import make_backend  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402

HUBERT, PALI = "hubert-xlarge", "paligemma-3b"
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
ENC_TOL = dict(atol=1e-5, rtol=1e-5)
MAX_LEN = 64
HEAD_DIMS = [None, 80, 256]          # None: the reduced config's own (64)


def _configs(arch, head_dim=None):
    jcfg, tcfg = jax_config(arch).reduced(), port_config(arch).reduced()
    if head_dim is not None:
        jcfg, tcfg = (dataclasses.replace(c, head_dim=head_dim)
                      for c in (jcfg, tcfg))
    return jcfg, tcfg


_PAIRS = {}


def _pair(arch, head_dim):
    """(jax cfg, jax params, port cfg, port params) with equal weights,
    made once per (arch, head_dim)."""
    key = (arch, head_dim)
    if key not in _PAIRS:
        jcfg, tcfg = _configs(arch, head_dim)
        jp = jax_model(jcfg).init(jax.random.PRNGKey(0))
        _PAIRS[key] = (jcfg, jp, tcfg, bridge.params_from_jax(
            jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    return _PAIRS[key]


def _ids(head_dim):
    return f"D{head_dim or 64}"


def _t(a):
    return torch.from_numpy(np.array(a))


def _features(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _prefix(cfg, b, seed):
    """Image-prefix embeddings as tests/test_smoke_archs.py makes them."""
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.num_prefix_tokens, cfg.d_model)) * 0.02).astype(np.float32)


def _prompts(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (b, s)).astype(np.int32)


def _close_scaled(port, ref, rtol=1e-4):
    """|port - ref| <= rtol * max |ref| (logits of one scale)."""
    ref = np.asarray(ref, np.float32)
    err = np.abs(port.float().numpy() - ref).max()
    assert err <= rtol * np.abs(ref).max(), (err, np.abs(ref).max())


# ---------------------------------------------------------------------------
# masks and B2's plain version
# ---------------------------------------------------------------------------

MASK_CASES = [("causal", 0), ("bidirectional", 0), ("prefix", 0),
              ("prefix", 5), ("prefix", 16), ("prefix", 40)]


@pytest.mark.parametrize("window", [None, 1, 7])
@pytest.mark.parametrize("q_offset", [0, 9])
@pytest.mark.parametrize("mode,prefix_len", MASK_CASES)
def test_make_mask_matches_jax(mode, prefix_len, q_offset, window):
    want = jax_layers.make_mask(13, 30, mode=mode, q_offset=q_offset,
                                window=window, prefix_len=prefix_len)
    got = port_layers.make_mask(13, 30, mode=mode, q_offset=q_offset,
                                window=window, prefix_len=prefix_len)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_make_mask_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="mask mode"):
        port_layers.make_mask(4, 4, mode="sliding")
    with pytest.raises(ValueError, match="mask mode"):
        flash_attention_ref(*(torch.zeros(1, 4, 1, 8),) * 3,
                            torch.zeros(1, dtype=torch.int32),
                            torch.full((1,), 4, dtype=torch.int32),
                            mode="sliding")


def test_family_mask_modes_match_the_jax_trunk():
    for arch in ("llama32-3b", "deepseek-moe-16b", "hymba-1.5b", HUBERT,
                 PALI):
        jm = jax_model(jax_config(arch).reduced())
        want = jm._mask(6, 6, prefix_len=2)
        mode = port_layers.mask_mode(port_config(arch))
        got = port_layers.make_mask(6, 6, mode=mode, prefix_len=2,
                                    window=port_config(arch).reduced()
                                    .sliding_window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


ATTN_CASES = [
    # (S, T, Hq, Hkv, D, mode, prefix_len, window)
    (24, 24, 4, 2, 64, "causal", 0, None),
    (24, 24, 4, 4, 80, "bidirectional", 0, None),
    (37, 37, 4, 2, 80, "bidirectional", 0, 9),
    (40, 40, 8, 1, 256, "prefix", 16, None),
    (40, 40, 8, 1, 256, "prefix", 21, 6),
    (33, 33, 4, 2, 64, "prefix", 0, None),
    (30, 30, 4, 1, 80, "prefix", 30, None),
]


@pytest.mark.parametrize("S,T,Hq,Hkv,D,mode,prefix_len,window", ATTN_CASES)
def test_flash_attention_ref_matches_jax_gqa_attention(S, T, Hq, Hkv, D, mode,
                                                       prefix_len, window):
    """B2's plain version in every mode against JAX's gqa_attention on
    make_mask(mode=...), f32, at head dims 64, 80 and 256, with the window
    and with prefix lengths off any tile grid; the CPU dispatcher
    (``flash_attention``) is the same function."""
    rng = np.random.default_rng(S + D)
    q = rng.standard_normal((2, S, Hq, D)).astype(np.float32)
    k, v = rng.standard_normal((2, 2, T, Hkv, D)).astype(np.float32)
    mask = jax_layers.make_mask(S, T, mode=mode, window=window,
                                prefix_len=prefix_len)
    want = jax_layers.gqa_attention(*map(jnp.asarray, (q, k, v)), mask)
    off = torch.zeros(2, dtype=torch.int32)
    kl = torch.full((2,), T, dtype=torch.int32)
    got = flash_attention_ref(_t(q), _t(k), _t(v), off, kl, window,
                              mode=mode, prefix_len=prefix_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    via = flash_attention(_t(q), _t(k), _t(v), off, kl, window, mode,
                          prefix_len)
    assert torch.equal(via, got)


@pytest.mark.parametrize("mode,prefix_len", [("bidirectional", 0),
                                             ("prefix", 11)])
def test_flash_attention_ref_ragged_lengths_and_offsets(mode, prefix_len):
    """Per-sequence KV lengths and query offsets (the kernel's serving
    arguments) in the new modes: each sequence equals the port's plain
    gqa_attention on make_mask over its own keys."""
    rng = np.random.default_rng(5)
    S, T, Hq, Hkv, D = 19, 40, 4, 2, 80
    q = rng.standard_normal((2, S, Hq, D)).astype(np.float32)
    k, v = rng.standard_normal((2, 2, T, Hkv, D)).astype(np.float32)
    offs, lens = [0, 14], [19, 33]
    got = flash_attention_ref(_t(q), _t(k), _t(v), torch.tensor(offs),
                              torch.tensor(lens), None, mode=mode,
                              prefix_len=prefix_len)
    for b, (o, n) in enumerate(zip(offs, lens)):
        mask = port_layers.make_mask(S, n, mode=mode, q_offset=o,
                                     prefix_len=prefix_len)
        want = port_layers.gqa_attention(_t(q[b:b + 1]), _t(k[b:b + 1, :n]),
                                         _t(v[b:b + 1, :n]), mask)
        torch.testing.assert_close(got[b:b + 1], want, **ATTN_TOL)


# ---------------------------------------------------------------------------
# hubert-xlarge: the encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim", HEAD_DIMS, ids=_ids)
def test_encoder_forward_and_encode_match_jax(head_dim):
    jcfg, jp, tcfg, tp = _pair(HUBERT, head_dim)
    f = _features(tcfg, 2, 37, seed=1)
    want, jaux = jax.jit(jax_model(jcfg).forward)(
        jp, features=jnp.asarray(f))
    got, aux = port_model(tcfg).forward(tp, features=_t(f))
    assert tuple(got.shape) == (2, 37, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENC_TOL)
    assert float(aux) == float(jaux) == 0.0
    enc = InferenceEngine(tcfg, tp, device="cpu").encode(f)
    jenc = JaxEngine(jcfg, jp).encode(jnp.asarray(f))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), **ENC_TOL)
    plain = InferenceEngine(tcfg, tp, device="cpu", plain=True).encode(f)
    torch.testing.assert_close(enc, plain, **ENC_TOL)


def test_encoder_is_bidirectional():
    """A change at the last frame moves the first frame's logits (it
    would not under a causal mask)."""
    _, _, tcfg, tp = _pair(HUBERT, None)
    f = _features(tcfg, 1, 12, seed=2)
    g = f.copy()
    g[0, -1] += 1.0
    a, _ = port_model(tcfg).forward(tp, features=_t(f))
    b, _ = port_model(tcfg).forward(tp, features=_t(g))
    assert float((a[0, 0] - b[0, 0]).abs().max()) > 1e-4


def test_encoder_init_and_bridge_round_trip():
    """No embedding for the encoder (it takes frame embeddings), an untied
    head; JAX's pytree carries over, and back, bit for bit (bf16 too)."""
    jcfg, tcfg = _configs(HUBERT)
    jp = jax_model(jcfg).init(jax.random.PRNGKey(3))
    assert "embed" not in jp and "lm_head" in jp
    shapes = bridge.expected_shapes(tcfg)
    assert "embed" not in shapes and shapes["lm_head"] == (
        tcfg.d_model, tcfg.padded_vocab)
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(tcfg, dtype=dt)
        own = port_model(cfg).init(seed=0, device="cpu")
        assert set(own) == {"blocks", "final_norm", "lm_head"}
        back = bridge.params_to_numpy(
            bridge.params_from_jax(bridge.params_to_numpy(own), cfg,
                                   device="cpu"))
        for key, val in bridge.params_to_numpy(own).items():
            if key == "blocks":
                for name, arr in val.items():
                    assert back[key][name].tobytes() == arr.tobytes(), name
            else:
                assert back[key].tobytes() == val.tobytes(), key
    np_jp = jax.tree.map(np.asarray, jp)
    back = bridge.params_to_numpy(bridge.params_from_jax(np_jp, tcfg,
                                                         device="cpu"))
    assert back["lm_head"].tobytes() == np_jp["lm_head"].tobytes()
    assert all(back["blocks"][k].tobytes() == v.tobytes()
               for k, v in np_jp["blocks"].items())


def test_encoder_does_not_decode_or_serve():
    _, _, tcfg, tp = _pair(HUBERT, None)
    eng = InferenceEngine(tcfg, tp, device="cpu")
    with pytest.raises(ValueError, match="encoder-only: no decode"):
        eng.generate(np.zeros((1, 4), np.int32), max_new_tokens=2)
    for kind, kw in (("gspmd", {}), ("gspmd", {"paged": True}),
                     ("tp", {"t": 2})):
        with pytest.raises(ValueError, match="encoder-only: no decode"):
            make_backend(kind, tcfg, tp, num_slots=2, device="cpu", **kw)


# ---------------------------------------------------------------------------
# paligemma-3b: the vlm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim", HEAD_DIMS, ids=_ids)
def test_vlm_forward_matches_jax(head_dim):
    """Full-sequence logits over 16 prefix embeddings and 12 tokens, and
    over the tokens alone (the mask then causal)."""
    jcfg, jp, tcfg, tp = _pair(PALI, head_dim)
    toks, pe = _prompts(tcfg, 2, 12, seed=1), _prefix(tcfg, 2, seed=1)
    fwd = jax.jit(jax_model(jcfg).forward)
    want, _ = fwd(jp, jnp.asarray(toks), prefix_emb=jnp.asarray(pe))
    got, aux = port_model(tcfg).forward(tp, _t(toks), prefix_emb=_t(pe))
    assert tuple(got.shape) == (2, 12 + tcfg.num_prefix_tokens,
                                tcfg.padded_vocab)
    _close_scaled(got, want)
    assert float(aux) == 0.0
    want, _ = fwd(jp, jnp.asarray(toks))
    got, _ = port_model(tcfg).forward(tp, _t(toks))
    _close_scaled(got, want)
    plain, _ = port_model(tcfg, plain=True).forward(tp, _t(toks),
                                                    prefix_emb=_t(pe))
    kern, _ = port_model(tcfg).forward(tp, _t(toks), prefix_emb=_t(pe))
    torch.testing.assert_close(kern, plain, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("head_dim", HEAD_DIMS, ids=_ids)
def test_vlm_prefill_and_decode_match_forward(head_dim):
    """Prefill of the prefix and 8 tokens, then 4 teacher-forced decode
    steps, against the port's own full-sequence logits (as
    tests/test_smoke_archs.py::test_decode_matches_forward holds JAX's),
    and the prefill's logits and cache against JAX's prefill."""
    jcfg, jp, tcfg, tp = _pair(PALI, head_dim)
    B, S, P = 2, 12, 8
    toks, pe = _prompts(tcfg, B, S, seed=2), _prefix(tcfg, B, seed=2)
    npre = tcfg.num_prefix_tokens
    tm = port_model(tcfg)
    full, _ = tm.forward(tp, _t(toks), prefix_emb=_t(pe))
    last, cache, done = tm.prefill(tp, _t(toks[:, :P]), S + npre + 4,
                                   prefix_emb=_t(pe))
    assert done == P + npre
    jl, jc, _ = jax.jit(jax_model(jcfg).prefill,
                        static_argnames=("max_len",))(
        jp, jnp.asarray(toks[:, :P]), max_len=S + npre + 4,
        prefix_emb=jnp.asarray(pe))
    _close_scaled(last, jl)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jc[key]),
                                   atol=1e-4, rtol=1e-4)
    errs = [float((last - full[:, npre + P - 1]).abs().max())]
    pos = P + npre
    for t in range(P, S):
        logits, cache = tm.decode_step(tp, cache, _t(toks[:, t]), pos)
        errs.append(float((logits - full[:, npre + t]).abs().max()))
        pos += 1
    scale = float(full.abs().max())
    assert max(errs) <= 1e-4 * scale, (errs, scale)


@pytest.mark.parametrize("head_dim", HEAD_DIMS, ids=_ids)
@pytest.mark.parametrize("chunk", [1, 8])
def test_vlm_generate_tokens_equal_jax_engine(head_dim, chunk):
    jcfg, jp, tcfg, tp = _pair(PALI, head_dim)
    toks, pe = _prompts(tcfg, 2, 10, seed=3), _prefix(tcfg, 2, seed=3)
    want = np.asarray(JaxEngine(jcfg, jp, max_len=MAX_LEN, decode_chunk=chunk)
                      .generate(jnp.asarray(toks), max_new_tokens=13,
                                prefix_emb=jnp.asarray(pe)))
    got = InferenceEngine(tcfg, tp, max_len=MAX_LEN, decode_chunk=chunk,
                          device="cpu").generate(toks, max_new_tokens=13,
                                                 prefix_emb=pe)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _trace(module, cfg):
    """Ragged text requests: 4 on 2 slots, staggered arrivals, an
    emulated early EOS."""
    rng = np.random.default_rng(0)
    spec = [(7, 6, 0.0, None), (21, 5, 0.0, None), (5, 7, 0.5, 3),
            (9, 3, 1.0, None)]
    return [module.Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, s),
                           max_new_tokens=n, arrival=a, eos_pos=eos)
            for i, (s, n, a, eos) in enumerate(spec)]


@pytest.mark.parametrize("head_dim", HEAD_DIMS, ids=_ids)
def test_vlm_ragged_scheduler_equals_jax_scheduler(head_dim):
    """paligemma's text requests through the contiguous Scheduler
    (``make_backend("gspmd")``; JAX's backends take no prefix
    embeddings): streams, step records and finish reasons equal JAX's."""
    jcfg, jp, tcfg, tp = _pair(PALI, head_dim)
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


def test_vlm_init_ties_and_scales_as_jax():
    """A tied head (no lm_head), the embedding scaled by sqrt(h) at the
    input: the port's own init has JAX's keys, and its first-layer input
    is the scaled embedding after the prefix."""
    jcfg, jp, tcfg, tp = _pair(PALI, None)
    assert set(jp) == set(tp) == {"blocks", "final_norm", "embed"}
    toks, pe = _prompts(tcfg, 1, 3, seed=4), _prefix(tcfg, 1, seed=4)
    x = port_model(tcfg)._embed(tp, _t(toks), _t(pe))
    want = jax_model(jcfg)._embed(jp, jnp.asarray(toks), jnp.asarray(pe))
    np.testing.assert_array_equal(x.numpy(), np.asarray(want))


def test_vlm_paged_tp_and_pp_raise():
    _, _, tcfg, tp = _pair(PALI, None)
    with pytest.raises(ValueError, match="paged mode covers dense"):
        make_backend("gspmd", tcfg, tp, num_slots=2, paged=True,
                     device="cpu")
    with pytest.raises(ValueError, match="paged KV cache covers dense"):
        port_model(tcfg).init_paged_cache(4, 16, device="cpu")
    with pytest.raises(ValueError, match="explicit TP engine covers the "
                                         "dense family"):
        make_backend("tp", tcfg, tp, num_slots=2, t=2, device="cpu")
    with pytest.raises(ValueError, match="PipelineEngine covers the dense "
                                         "family"):
        make_backend("pp", tcfg, tp, num_slots=2, p=2, device="cpu")


def test_encoder_tp_raises():
    from repro_torch.core.parallel_exec import check_tp_config
    _, tcfg = _configs(HUBERT)
    with pytest.raises(ValueError, match="explicit TP engine covers the "
                                         "dense family"):
        check_tp_config(tcfg, 2)
