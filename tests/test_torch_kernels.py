"""The PyTorch port's kernel modules against the JAX package.

On the CPU each port wrapper runs its kernel's plain PyTorch version; the
same numpy inputs (made from a seed) go through the JAX package's Pallas
kernel in interpret mode, or its jnp reference, and the two must agree.
Everything is float32: the point here is the algorithm (masks, offsets,
lengths, page addressing), and in f32 the two frameworks differ only in
the order of their sums.  Tolerance 2e-5 absolute and relative.

The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.decode_kernel import \
    decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import \
    paged_decode_attention_ref  # noqa: E402
from repro.kernels.flash_attention.flash_kernel import \
    flash_attention_pallas  # noqa: E402
from repro.kernels.rmsnorm.ref import rms_norm_ref  # noqa: E402
from repro.kernels.rmsnorm.rmsnorm_kernel import rms_norm_pallas  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, paged_decode_attention)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.rmsnorm import rms_norm  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
GEOMETRIES = [  # (Hkv, G, D): G = 1 (MHA), G = 3 (llama32-3b's), D = 128
    (2, 1, 32), (2, 3, 32), (1, 3, 128), (2, 1, 128)]


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _i32(vals):
    return torch.tensor(vals, dtype=torch.int32)


# ---------------------------------------------------------------------------
# B1 RMSNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 3072), (2, 96)])
def test_rmsnorm_matches_pallas_and_ref(shape):
    rng = np.random.default_rng(0)
    x = _randn(rng, shape)
    w = 0.1 * _randn(rng, shape[-1:])
    got = rms_norm(_t(x), _t(w)).numpy()
    want_k = np.asarray(rms_norm_pallas(jnp.asarray(x), jnp.asarray(w),
                                        interpret=True))
    want_r = np.asarray(rms_norm_ref(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, want_k, **TOL)
    np.testing.assert_allclose(got, want_r, **TOL)


# ---------------------------------------------------------------------------
# B2 flash prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("hkv,g,d", GEOMETRIES)
def test_flash_offset0_matches_pallas(hkv, g, d, window):
    """Whole-prompt prefill (offset 0, kv_len = S) == the Pallas kernel."""
    rng = np.random.default_rng(hkv * 100 + g * 10 + d)
    B, S = 2, 128
    q = _randn(rng, (B, S, hkv * g, d))
    k = _randn(rng, (B, S, hkv, d))
    v = _randn(rng, (B, S, hkv, d))
    got = flash_attention(_t(q), _t(k), _t(v), _i32([0] * B), _i32([S] * B),
                          window).numpy()
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=window,
                                  block_q=64, block_kv=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("hkv,g,d", GEOMETRIES)
def test_flash_per_sequence_offsets_match_paged_mask(hkv, g, d):
    """A paged prefill chunk: query s of sequence b at pos[b] + s over a
    gathered view, kv_len pos[b] + S, ragged S == the JAX model's
    gqa_attention under paged_attn_mask."""
    rng = np.random.default_rng(d + g)
    B, S, T = 3, 13, 48
    pos = np.array([0, 7, 35], np.int32)
    q = _randn(rng, (B, S, hkv * g, d))
    k = _randn(rng, (B, T, hkv, d))
    v = _randn(rng, (B, T, hkv, d))
    got = flash_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos + S)).numpy()
    mask = jlayers.paged_attn_mask(T, jnp.asarray(pos), S)
    want = jlayers.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), mask)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# B3 contiguous flash-decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hkv,g,d", GEOMETRIES)
def test_decode_equal_lengths_matches_pallas(hkv, g, d):
    """All sequences at one length == the TPU kernel's shared valid mask."""
    rng = np.random.default_rng(g * d)
    B, W, L = 2, 64, 37
    q = _randn(rng, (B, hkv * g, d))
    k = _randn(rng, (B, W, hkv, d))
    v = _randn(rng, (B, W, hkv, d))
    got = decode_attention(_t(q), _t(k), _t(v), _i32([L] * B)).numpy()
    valid = jnp.arange(W) < L
    want = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), valid, block_kv=32,
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("window,pos", [
    (None, [0, 5, 30, 63]),          # ragged, inside the cache
    (32, [3, 31, 32, 100]),          # sliding window: ring wrap past W
])
@pytest.mark.parametrize("hkv,g,d", GEOMETRIES)
def test_decode_per_sequence_pos_matches_decode_attn_mask(hkv, g, d,
                                                          window, pos):
    """Per-sequence positions pos[B] (continuous batching) == the JAX
    model's gqa_attention under decode_attn_mask, wrap included."""
    rng = np.random.default_rng(d - g)
    B = len(pos)
    W = window or 64
    q = _randn(rng, (B, hkv * g, d))
    k = _randn(rng, (B, W, hkv, d))
    v = _randn(rng, (B, W, hkv, d))
    pos = np.asarray(pos, np.int32)
    lengths = tlayers.decode_lengths(W, _t(pos), B)
    got = decode_attention(_t(q), _t(k), _t(v), lengths).numpy()
    mask = jlayers.decode_attn_mask(W, jnp.asarray(pos), window)
    want = jlayers.gqa_attention(jnp.asarray(q)[:, None], jnp.asarray(k),
                                 jnp.asarray(v), mask)[:, 0]
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# B4 paged flash-decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ps", [4, 16])
@pytest.mark.parametrize("hkv,g,d", GEOMETRIES)
def test_paged_ragged_shuffled_matches_ref(hkv, g, d, ps):
    """Ragged lengths, a shuffled block table and an inactive slot whose
    row is all scratch page 0 == the JAX paged reference."""
    rng = np.random.default_rng(ps * d + g)
    B, n = 4, 6
    P = 1 + B * n
    table = (rng.permutation(P - 1) + 1).astype(np.int32).reshape(B, n)
    table[2] = 0                                 # inactive: scratch page
    lengths = np.array([1, ps * n, 1, ps * 2 + 3], np.int32)
    q = _randn(rng, (B, hkv * g, d))
    kp = _randn(rng, (P, ps, hkv, d))
    vp = _randn(rng, (P, ps, hkv, d))
    got = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                 _t(lengths)).numpy()
    want = paged_decode_attention_ref(jnp.asarray(q), jnp.asarray(kp),
                                      jnp.asarray(vp), jnp.asarray(table),
                                      jnp.asarray(lengths))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
