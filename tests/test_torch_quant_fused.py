"""The int4 wire's three fused passes against the JAX chains they replace.

``chunk_quantize_pack``, ``nibble_reduce_requant`` and
``nibble_unpack_dequantize`` (``repro_torch.kernels.quant_collective``)
each fuse a chain of the quantized all-reduce's int4 branch into one
kernel on the card; their plain versions (``ref.py``) are what the kernels
are held to bit for bit.  Here each plain version is held, bit for bit, to
the JAX package's chain it replaces, with the Pallas kernels run as
``interpret=True``:

* ``chunk_quantize_pallas`` (int8 grid) -> ``nibble_pack_pallas``;
* ``nibble_unpack_pallas`` -> the jnp sum / round / clip of
  ``repro.core.parallel_exec.quantized_psum`` -> ``nibble_pack_pallas``;
* ``nibble_unpack_pallas`` -> ``chunk_dequantize_pallas``;

on f32 and bf16, on h = 256 / chunk 128, h = 160 / chunk 64 and an odd
chunk (pairs of values straddle two scales), at t in {2, 4}, over every
nibble value and every sum from -8t to 7t (the .5 ties of t = 2
included).  Then the int4 branch of ``quantized_psum`` against the unfused
chain of plain ops it replaced, and its comm log.

Inputs come from seeded numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.quant_collective.quant_kernel import (  # noqa: E402
    chunk_dequantize_pallas, chunk_quantize_pallas, nibble_pack_pallas,
    nibble_unpack_pallas)
from repro_torch.core import comm  # noqa: E402
from repro_torch.core.parallel_exec import quantized_psum  # noqa: E402
from repro_torch.kernels.quant_collective import ops as qops  # noqa: E402
from repro_torch.kernels.quant_collective import ref as qref  # noqa: E402

DTYPES = [pytest.param((jnp.float32, torch.float32), id="f32"),
          pytest.param((jnp.bfloat16, torch.bfloat16), id="bf16")]
# (lead shape, h, chunk); chunk 25 is odd, so pairs straddle two chunks
SHAPES = [pytest.param((3,), 256, 128, id="h256-c128"),
          pytest.param((3,), 160, 64, id="h160-c64"),
          pytest.param((2, 3), 200, 25, id="h200-c25-odd")]


def _bits(a):
    """Raw bytes of a numpy array or a torch tensor, for bitwise checks."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.view(torch.uint8).numpy() if a.element_size() == 1 \
            else a.numpy().view(np.uint8)
    return np.ascontiguousarray(a).view(np.uint8)


def _inputs(lead, h, chunk, seed, dtypes):
    """x [*lead, h] in the working dtype on both sides (the same bf16 bits)
    and f32 scales [*lead, K]: tight enough that |x/s| reaches ~4x the int8
    range (so the +-127 clip binds and values leave the 4-bit grid, whose
    low nibbles then pack as the chain packs them), and one zero scale
    (taken as 1 by both)."""
    jdt, tdt = dtypes
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((*lead, h))).astype(np.float32)
    k = -(-h // chunk)
    scales = (np.abs(rng.standard_normal((*lead, k))) / 40.0 + 1e-3) \
        .astype(np.float32)
    scales[..., 1::3] *= 40.0            # on-grid chunks beside clipped ones
    scales.reshape(-1)[0] = 0.0
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(x).to(tdt)
    assert np.array_equal(_bits(np.asarray(xj)), _bits(xt))
    return xj, xt, scales


@pytest.mark.parametrize("dtypes", DTYPES)
@pytest.mark.parametrize("lead,h,chunk", SHAPES)
def test_chunk_quantize_pack_plain_equals_pallas_chain(lead, h, chunk,
                                                       dtypes):
    xj, xt, scales = _inputs(lead, h, chunk, h + chunk, dtypes)
    q = chunk_quantize_pallas(xj, jnp.asarray(scales), chunk=chunk,
                              qdtype=jnp.int8, interpret=True)
    assert int(jnp.abs(q).max()) == 127          # the clip binds
    want = np.asarray(nibble_pack_pallas(q, interpret=True))
    got = qref.chunk_quantize_pack_ref(xt, torch.from_numpy(scales), chunk)
    assert got.dtype == torch.uint8 and got.shape == (*lead, h // 2)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the dispatcher takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        _bits(qops.chunk_quantize_pack(xt, torch.from_numpy(scales), chunk)),
        _bits(want))


def _jax_reduce_requant(packed, t):
    """The JAX chain the fused reduce replaces: Pallas unpack, then the jnp
    lines of ``repro.core.parallel_exec.quantized_psum`` (int4 branch),
    then Pallas pack."""
    qa = nibble_unpack_pallas(jnp.asarray(packed), interpret=True)
    h = qa.shape[-1]
    r = qa.astype(jnp.int32).reshape(*qa.shape[:-1], t, h // t).sum(axis=-2)
    rq = jnp.clip(jnp.round(r.astype(jnp.float32) / t), -7, 7) \
        .astype(jnp.int8)
    return np.asarray(nibble_pack_pallas(rq, interpret=True))


def _every_sum(t, seed):
    """int4 values [rows, t, w] whose t-way sums over axis 1 take every
    value from -8t to 7t, beside random rows over all 16 nibble values."""
    rng = np.random.default_rng(seed)
    sums = np.arange(-8 * t, 7 * t + 1)
    w = 2 * len(sums)                     # even: whole packed bytes
    vals = np.empty((4, t, w), np.int64)
    for row in range(2):                  # row 1: the sums in another order
        target = np.resize(rng.permutation(sums) if row else sums, w)
        left = target.copy()
        for s in range(t):                # spread a sum over the t sources
            rest = t - 1 - s
            v = np.clip(left, -8, 7)
            v = np.clip(v, left - 7 * rest, left + 8 * rest)
            vals[row, s], left = v, left - v
        assert not left.any() and (vals[row].sum(axis=0) == target).all()
    vals[2:] = rng.integers(-8, 8, (2, t, w))
    return vals.astype(np.int8)


@pytest.mark.parametrize("t", [2, 4])
def test_nibble_reduce_requant_plain_equals_jax_chain(t):
    """Every sum from -8t to 7t (all .5 ties at t = 2) and every nibble
    value: the all-to-all's [rows, m] bytes, t source blocks of m/t."""
    vals = _every_sum(t, seed=t)
    rows, _, w = vals.shape
    q = vals.reshape(rows, t * w)         # source s at columns [s*w, s*w+w)
    packed = np.array(nibble_pack_pallas(jnp.asarray(q), interpret=True))
    assert set(np.unique(packed & 0xF)) == set(range(16))
    want = _jax_reduce_requant(packed, t)
    got = qref.nibble_reduce_requant_ref(torch.from_numpy(packed), t)
    assert got.dtype == torch.uint8 and got.shape == (rows, w // 2)
    np.testing.assert_array_equal(_bits(got), want)
    np.testing.assert_array_equal(
        _bits(qops.nibble_reduce_requant(torch.from_numpy(packed), t)), want)
    # round half to even, clip to +-7: checked on the values themselves
    r = vals.astype(np.int64).sum(axis=1)
    expect = np.clip(np.rint(r / t), -7, 7)
    np.testing.assert_array_equal(
        qref.nibble_unpack_ref(got).numpy(), expect)


def test_requantize_ties_round_half_to_even():
    """At t = 2 every odd sum lands on .5: r = 1 -> 0, 3 -> 2, -3 -> -2,
    -1 -> 0, 5 -> 2, 7 -> 4; past the grid, 14 -> 7 and -16 -> -7
    (clipped)."""
    r = np.array([1, 3, -3, -1, 5, 7, 14, -16])
    src = np.stack([np.clip(r, -8, 7), r - np.clip(r, -8, 7)])   # [2, 8]
    packed = qref.nibble_pack_ref(torch.from_numpy(
        src.reshape(1, 16).astype(np.int8)))
    got = qref.nibble_unpack_ref(qref.nibble_reduce_requant_ref(packed, 2))
    assert got.tolist() == [[0, 2, -2, 0, 2, 4, 7, -7]]
    np.testing.assert_array_equal(_bits(qref.nibble_reduce_requant_ref(
        packed, 2)), _jax_reduce_requant(packed.numpy(), 2))


def test_nibble_reduce_requant_rejects_blocks_that_do_not_divide():
    with pytest.raises(ValueError, match="2t"):
        qref.nibble_reduce_requant_ref(torch.zeros(2, 6, dtype=torch.uint8),
                                       4)


@pytest.mark.parametrize("dtypes", DTYPES)
@pytest.mark.parametrize("lead,h,chunk", SHAPES)
def test_nibble_unpack_dequantize_plain_equals_pallas_chain(lead, h, chunk,
                                                            dtypes):
    """Every byte value (so every nibble in both halves) against random
    scales, dequantized to f32 and bf16."""
    jdt, tdt = dtypes
    rng = np.random.default_rng(h)
    lead, m = (4, *lead), h // 2          # at least 256 bytes
    b = np.resize(rng.permutation(256), (*lead, m)).astype(np.uint8)
    assert len(np.unique(b)) == 256
    scales = (np.abs(rng.standard_normal((*lead, -(-h // chunk)))) * 0.37) \
        .astype(np.float32)
    want = np.asarray(chunk_dequantize_pallas(
        nibble_unpack_pallas(jnp.asarray(b), interpret=True),
        jnp.asarray(scales), chunk=chunk, out_dtype=jdt, interpret=True))
    got = qref.nibble_unpack_dequantize_ref(
        torch.from_numpy(b), torch.from_numpy(scales), chunk, tdt)
    assert got.dtype == tdt and got.shape == (*lead, h)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(qops.nibble_unpack_dequantize(
        torch.from_numpy(b), torch.from_numpy(scales), chunk, tdt)),
        _bits(want))


# ---------------------------------------------------------------------------
# the int4 branch of quantized_psum
# ---------------------------------------------------------------------------


def _unfused_int4_psum(xs, t, chunk):
    """The int4 branch as it ran before the fusion: B6 (int8 grid), B7, the
    all-to-all, B8, the torch sum / round / clip, B7, the all-gather, B8,
    B9 — each step a plain op, on the wire as the comm layer tiles it."""
    lead, h = xs[0].shape[:-1], xs[0].shape[-1]
    amax = torch.stack([qref.chunk_amax_ref(x, chunk) for x in xs]) \
        .amax(dim=0)
    scales = qops.scales_from_amax(amax, qops.collective_qmax("int4", t))
    packed = [qref.nibble_pack_ref(qref.chunk_quantize_ref(
        x, scales, chunk, torch.int8)) for x in xs]
    blocks = [p.chunk(t, dim=-1) for p in packed]
    reduced = []
    for dst in range(t):
        got = torch.cat([blocks[src][dst] for src in range(t)], dim=-1)
        r = qref.nibble_unpack_ref(got).to(torch.int32).reshape(
            *lead, t, h // t).sum(dim=-2)
        rq = torch.clamp(torch.round(r.float() / t), -7, 7)
        reduced.append(qref.nibble_pack_ref(rq.to(torch.int8)))
    return qref.chunk_dequantize_ref(
        qref.nibble_unpack_ref(torch.cat(reduced, dim=-1)), scales * t,
        chunk, xs[0].dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("h,chunk", [(256, 128), (160, 64), (200, 25)])
@pytest.mark.parametrize("plain", [False, True], ids=["dispatch", "plain"])
def test_int4_psum_equals_the_unfused_chain(h, chunk, t, dtype, plain):
    if h % (2 * t):
        pytest.skip("int4 needs h % 2t == 0")
    rng = np.random.default_rng(h * t)
    xs = [torch.from_numpy(2.0 * rng.standard_normal((2, 3, h))
                           .astype(np.float32)).to(dtype) for _ in range(t)]
    got = quantized_psum(xs, comm.VirtualGroup(t), "int4", chunk,
                         plain=plain)
    want = _unfused_int4_psum(xs, t, chunk)
    assert got.dtype == dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("t", [2, 4])
def test_int4_psum_comm_log_is_unchanged(t):
    """One int4 all-reduce logs what it logged before the fusion: the f32
    [rows, K] max all-reduce, the all-to-all of one rank's packed row
    ([rows, h/2] uint8 at two values a byte: [rows, h] at 0.5 bytes) and
    the all-gather of one rank's packed block ([rows, h/(2t)] uint8:
    [rows, h/t] at 0.5 bytes)."""
    h, chunk = 256, 64
    rng = np.random.default_rng(t)
    xs = [torch.from_numpy(rng.standard_normal((3, h)).astype(np.float32))
          for _ in range(t)]
    group = comm.VirtualGroup(t)
    with group.phase("decode"):
        quantized_psum(xs, group, "int4", chunk)
    assert group.log == [
        comm.CommRecord("allreduce", "decode", (3, h // chunk), 4.0, t),
        comm.CommRecord("alltoall", "decode", (3, h), 0.5, t),
        comm.CommRecord("allgather", "decode", (3, h // t), 0.5, t)]
