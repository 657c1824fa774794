"""The split-KV arithmetic of B3 and B4 and B2's bf16-P numerics against
the JAX package.

No CUDA kernel runs on the CPU, so what each computes is modelled in plain
PyTorch beside its plain version:

* ``split_partials`` and ``combine_partials`` (``decode_attention/ref.py``)
  are the split pass and combine pass of B4, over the split geometry its
  wrapper launches with (``decode_attention.ops.split_geometry``), and of
  B3, over rows of a contiguous cache in splits of ``SPLIT_KEYS``;
* ``flash_attention_ref(..., p_dtype=torch.bfloat16)`` is B2's bf16
  tensor-core kernel, which rounds the probabilities to bf16 before P·V.

The same numpy inputs (from a seed) go through the JAX package's paged and
contiguous references and its Pallas kernels in interpret mode, in f32 with the
tolerance of ``test_torch_kernels.py`` (2e-5: the two frameworks differ
only in the order of their sums), and through JAX's flash reference in
bf16 with the bf16 tolerance the kernels are held to on the card
(``chip_smoke.TOLERANCE["bfloat16"]``: 1e-2 + 1e-2·|ref|).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.decode_kernel import \
    decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.paged_kernel import \
    paged_decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.decode_attention.ref import \
    paged_decode_attention_ref  # noqa: E402
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dref  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    SPLIT_KEYS, split_geometry)
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


def _inputs(seed, B, Hkv, G, D, ps, n):
    """q, pools and a shuffled block table (page 0 is the scratch page)."""
    rng = np.random.default_rng(seed)
    P = 1 + B * n
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    kp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    table = (rng.permutation(P - 1) + 1).astype(np.int32).reshape(B, n)
    return q, kp, vp, table


def _split_then_combine(q, kp, vp, table, lengths):
    """B4's two passes, in plain PyTorch, over the wrapper's geometry;
    also returns the partials."""
    ps, n = kp.shape[1], table.shape[1]
    pps, n_splits = split_geometry(ps, n)
    t = [torch.from_numpy(a) for a in (q, kp, vp, table, lengths)]
    m, l, acc = dref.split_partials(t[0], t[1], t[2], t[4], pps * ps,
                                    block_tables=t[3])
    assert m.shape == (q.shape[0], q.shape[1], n_splits)
    out = dref.combine_partials(m, l, acc, t[4], n * ps, pps * ps,
                                torch.float32)
    return out.numpy(), m


@pytest.mark.parametrize("ps,n,want", [
    (16, 64, (8, 8)),       # llama32-3b serving: 128 keys, 8 splits
    (5, 205, (25, 9)),      # a page size that does not divide 128
    (1, 3, (128, 1)),       # more pages per split than the table has
    (128, 4, (1, 4)),       # one page per split
    (300, 2, (1, 2)),       # a page larger than a split's keys
])
def test_split_geometry(ps, n, want):
    """Whole pages, about SPLIT_KEYS keys a split, from the table width."""
    pps, n_splits = split_geometry(ps, n)
    assert (pps, n_splits) == want
    assert (n_splits - 1) * pps < n <= n_splits * pps
    assert pps * ps <= max(SPLIT_KEYS, ps)


def _boundary_lengths(ps, span):
    """1, exactly on a split boundary, one past it, and the whole span."""
    rows = split_geometry(ps, 1)[0] * ps
    return np.array([1, rows, rows + 1, span], np.int32)


@pytest.mark.parametrize("hkv,g,d", [(2, 3, 32), (1, 3, 128), (2, 1, 64)])
@pytest.mark.parametrize("ps", [5, 16])
def test_split_then_combine_matches_jax_ref(ps, hkv, g, d):
    """Lengths 1, on a split boundary, one past it and a 1024-token
    sequence beside them (so the short rows' later splits are all empty),
    and again with an inactive slot whose table row is all scratch page 0
    == the JAX paged reference; the output has no NaN even though the
    empty splits' partials are NaN."""
    n = -(-1024 // ps)
    q, kp, vp, table = _inputs(ps * d + g, 4, hkv, g, d, ps, n)
    lengths = _boundary_lengths(ps, 1024)
    for rows, lens in ((table, lengths),
                       (np.where(np.arange(4)[:, None] == 1, 0, table),
                        np.array([lengths[0], 1, lengths[2], 1024],
                                 np.int32))):
        got, m = _split_then_combine(q, kp, vp, rows, lens)
        assert torch.isnan(m).any() and np.isfinite(got).all()
        want = paged_decode_attention_ref(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(rows), jnp.asarray(lens))
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("ps", [5, 16])
def test_split_then_combine_matches_pallas(ps):
    """The same boundary lengths over a shorter table == the TPU kernel in
    interpret mode."""
    n = -(-300 // ps)
    q, kp, vp, table = _inputs(ps, 4, 1, 3, 32, ps, n)
    lengths = _boundary_lengths(ps, 300)
    got, _ = _split_then_combine(q, kp, vp, table, lengths)
    want = paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_combine_reads_only_live_splits():
    """The combine pass takes the live split count from the lengths: any
    value in a later split's partials (here inf and NaN) changes nothing,
    a length of 0 gives 0, and a split whose rows are all masked (m at
    finfo(f32).min, l = 0) adds nothing and makes no NaN."""
    rng = np.random.default_rng(3)
    B, Hq, ns, D, rows = 3, 2, 4, 8, 16
    m = torch.from_numpy(rng.standard_normal((B, Hq, ns)).astype(np.float32))
    l = torch.from_numpy(rng.uniform(1, 2, (B, Hq, ns)).astype(np.float32))
    acc = torch.from_numpy(
        rng.standard_normal((B, Hq, ns, D)).astype(np.float32))
    lens = torch.tensor([rows + 1, 0, 4 * rows], dtype=torch.int32)
    want = dref.combine_partials(m, l, acc, lens, ns * rows, rows,
                                 torch.float32)
    m2, l2, acc2 = m.clone(), l.clone(), acc.clone()
    m2[0, :, 2:], l2[0, :, 2:], acc2[0, :, 2:] = float("inf"), float("nan"), \
        float("nan")
    m2[1], l2[1], acc2[1] = float("nan"), float("nan"), float("nan")
    got = dref.combine_partials(m2, l2, acc2, lens, ns * rows, rows,
                                torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(got[1], torch.zeros(Hq, D))
    m3, l3, acc3 = m.clone(), l.clone(), acc.clone()
    m3[2, :, 3], l3[2, :, 3], acc3[2, :, 3] = \
        torch.finfo(torch.float32).min, 0.0, 0.0
    got3 = dref.combine_partials(m3, l3, acc3, lens, ns * rows, rows,
                                 torch.float32)
    w = torch.exp(m[2, :, :3] - m[2, :, :3].amax(-1, keepdim=True))
    want3 = (acc[2, :, :3] * w[..., None]).sum(-2) / \
        (l[2, :, :3] * w).sum(-1, keepdim=True)
    torch.testing.assert_close(got3[2], want3, **TOL)


# B3: a contiguous ring cache [B, W, Hkv, D] in splits of SPLIT_KEYS rows
CONTIG_W = 300          # not a multiple of the split: a ragged last split


def _contig_inputs(seed, B, Hkv, G, D, W):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hkv * G, D)).astype(np.float32),
            rng.standard_normal((B, W, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, W, Hkv, D)).astype(np.float32))


def _contig_split_then_combine(q, k, v, lengths):
    """B3's two passes, in plain PyTorch, over the wrapper's geometry."""
    W = k.shape[1]
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (q, k, v, lengths)]
    m, l, acc = dref.split_partials(*t, SPLIT_KEYS)
    assert m.shape == (q.shape[0], q.shape[1], -(-W // SPLIT_KEYS))
    return dref.combine_partials(m, l, acc, t[3], W, SPLIT_KEYS,
                                 torch.float32).numpy(), m


def _contig_lengths(W):
    """One key, one short of a split, on its edge, one past it, all W."""
    return np.array([1, SPLIT_KEYS - 1, SPLIT_KEYS, SPLIT_KEYS + 1, W],
                    np.int32)


@pytest.mark.parametrize("hkv,g,d", [(2, 3, 32), (1, 3, 128), (2, 1, 64),
                                     (1, 8, 32)])
def test_contiguous_split_then_combine_matches_jax_ref(hkv, g, d):
    """B3's split pass + combine pass at lengths 1, 127, 128, 129 and W,
    one per sequence, == the JAX contiguous reference with each sequence's
    own valid mask; the later splits of the short rows are empty (NaN
    partials) and the output has no NaN."""
    lengths = _contig_lengths(CONTIG_W)
    q, k, v = _contig_inputs(d + g, len(lengths), hkv, g, d, CONTIG_W)
    got, m = _contig_split_then_combine(q, k, v, lengths)
    assert torch.isnan(m).any() and np.isfinite(got).all()
    for b, n in enumerate(lengths):
        want = jax_decode_ref(jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
                              jnp.asarray(v[b:b + 1]),
                              jnp.arange(CONTIG_W) < n)
        np.testing.assert_allclose(got[b:b + 1], np.asarray(want), **TOL)


@pytest.mark.parametrize("length", list(_contig_lengths(CONTIG_W)))
def test_contiguous_split_then_combine_matches_pallas(length):
    """Every sequence at one length (the TPU kernel takes one valid mask
    for the batch) == ``decode_attention_pallas`` in interpret mode."""
    q, k, v = _contig_inputs(int(length), 2, 2, 3, 32, CONTIG_W)
    lengths = np.full(2, length, np.int32)
    got, _ = _contig_split_then_combine(q, k, v, lengths)
    want = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v),
                                   jnp.arange(CONTIG_W) < length,
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_contiguous_split_reads_a_strided_view():
    """A slot-subset view of a [L, B, W, Hkv, D] cache (what the engine
    hands B3) gives what its contiguous copy gives, bit for bit."""
    big = _contig_inputs(5, 6, 2, 3, 32, CONTIG_W)[1]
    q = _contig_inputs(6, 3, 2, 3, 32, 1)[0]
    lengths = np.array([1, 129, CONTIG_W], np.int32)
    view = torch.from_numpy(big)[1::2]
    assert not view.is_contiguous()
    tq, tl = torch.from_numpy(q), torch.from_numpy(lengths)
    got = dref.split_partials(tq, view, view, tl, SPLIT_KEYS)
    want = dref.split_partials(tq, view.contiguous(), view.contiguous(), tl,
                               SPLIT_KEYS)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("hkv,window", [(1, None), (2, None), (1, 100)])
def test_flash_bf16_p_model_matches_jax_ref(hkv, window):
    """B2's bf16 numerics — the plain version with the probabilities
    rounded to bf16 before P·V — against JAX's flash reference in bf16 at
    G = 3, D = 128, S = 333 (llama32-3b's group and head width, a ragged
    prompt): within the bf16 tolerance the kernel is held to."""
    rng = np.random.default_rng(333 + hkv)
    S, G, D = 333, 3, 128

    def bf16(shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(torch.bfloat16)
    q, k, v = bf16((1, S, hkv * G, D)), bf16((1, S, hkv, D)), \
        bf16((1, S, hkv, D))
    got = flash_attention_ref(q, k, v, torch.zeros(1, dtype=torch.int32),
                              torch.full((1,), S, dtype=torch.int32), window,
                              p_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16

    def jx(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    want = jax_flash_ref(jx(q), jx(k), jx(v), causal=True, window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)
