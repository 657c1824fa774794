"""B6 with the shared scale computed inside it, against the JAX chain.

The quantized all-reduce's quantize (B6 on int8/fp8, B6 + B7 on int4)
takes the all-reduced abs-max and computes the shared scale itself; on the
card nothing runs between the abs-max's all-reduce and the quantize.  Its
plain versions (``quant_collective/ref.py`` ``chunk_quantize_shared_ref``
and ``chunk_quantize_pack_shared_ref``, what the kernel is held to bit for
bit on the card) are held here, bit for bit, to the JAX chain they
replace:

* ``jops.scales_from_amax`` under ``jax.jit`` (the compiled engine's
  scales), then ``chunk_quantize_pallas`` with ``interpret=True`` (int8,
  fp8), or for int4 ``chunk_quantize_pallas`` onto the int8 grid then
  ``nibble_pack_pallas``; the scales they write (times t on int4) to the
  jitted scales (times t in jnp);

on f32 and bf16, h = 256 / chunk 128, a ragged h = 160 / chunk 64 and an
odd chunk 25 (int4 pairs straddle two scales), at t = 2, 4 and 8, with an
all-zero chunk, a NaN and an infinite abs-max, and chunks whose abs-max is
below their values' (the clips bind).  Then ``quantized_psum_gathered``
and ``quantized_psum``, through the dispatch and with the plain versions,
against the composition they replaced (``scales_from_amax`` ->
``chunk_quantize`` / ``chunk_quantize_pack`` -> the hops -> the dequantize
with the scales, times t on int4), bit for bit, with the same comm log.

Inputs come from seeded numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.quant_collective import ops as jops  # noqa: E402
from repro.kernels.quant_collective.quant_kernel import (  # noqa: E402
    chunk_quantize_pallas, nibble_pack_pallas)
from repro_torch.core import comm  # noqa: E402
from repro_torch.core import parallel_exec as px  # noqa: E402
from repro_torch.kernels.quant_collective import ops as qops  # noqa: E402
from repro_torch.kernels.quant_collective import ref as qref  # noqa: E402

DTYPES = [pytest.param((jnp.float32, torch.float32), id="f32"),
          pytest.param((jnp.bfloat16, torch.bfloat16), id="bf16")]
WIRE = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn, "int4": jnp.int8}
# (lead shape, h, chunk): even, ragged (h % chunk != 0), odd chunk
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


def _inputs(lead, h, chunk, t, seed, dtypes):
    """Rank 0's x [*lead, h] in the working dtype on both sides (the same
    bits) and the f32 abs-max [*lead, K] all-reduced over t ranks' rows,
    then edited: chunk 0 of the first row all zeros (x and abs-max), a NaN
    abs-max and an infinite one, and every third chunk's abs-max cut 40x
    below its values' (x / scale leaves the grid: the clips bind)."""
    jdt, tdt = dtypes
    rng = np.random.default_rng(seed)
    xs = (3.0 * rng.standard_normal((t, *lead, h))).astype(np.float32)
    k = -(-h // chunk)
    xs.reshape(t, -1, h)[:, 0, :chunk] = 0.0            # an all-zero chunk
    xt = torch.from_numpy(xs[0]).to(tdt)
    xj = jnp.asarray(xs[0]).astype(jdt)
    assert np.array_equal(_bits(np.asarray(xj)), _bits(xt))
    amax = qref.chunk_amax_ref(torch.from_numpy(xs).to(tdt), chunk) \
        .amax(dim=0).numpy()
    assert amax.reshape(-1, k)[0, 0] == 0.0
    amax[..., 1::3] /= 40.0
    flat = amax.reshape(-1)
    flat[1], flat[-1] = np.nan, np.inf
    return xj, xt, amax


def _jax_chain(xj, amax, qmax, chunk, quant, t):
    """What the JAX package runs: the jitted shared scales, then the Pallas
    quantize (and pack for int4); the scales the dequantize takes."""
    scales = jax.jit(lambda a, q=qmax: jops.scales_from_amax(a, q))(
        jnp.asarray(amax))
    q = chunk_quantize_pallas(xj, scales, chunk=chunk, qdtype=WIRE[quant],
                              interpret=True)
    if quant == "int4":
        return np.asarray(nibble_pack_pallas(q, interpret=True)), \
            np.asarray(scales * t)
    return np.asarray(q), np.asarray(scales)


def _port(x, amax, qmax, chunk, quant, t, write, fn_int, fn_int4):
    if quant == "int4":
        return fn_int4(x, amax, qmax, chunk, t, write)
    return fn_int(x, amax, qmax, chunk, quant, write)


@pytest.mark.parametrize("dtypes", DTYPES)
@pytest.mark.parametrize("t", [2, 4, 8])
@pytest.mark.parametrize("quant", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("lead,h,chunk", SHAPES)
def test_shared_scale_quantize_plain_equals_jax_chain(lead, h, chunk, quant,
                                                      t, dtypes):
    xj, xt, amax = _inputs(lead, h, chunk, t, h * t + chunk, dtypes)
    qmax = qops.collective_qmax(quant, t)
    want_q, want_s = _jax_chain(xj, amax, qmax, chunk, quant, t)
    # the clips bind somewhere, and the NaN / inf abs-max give 1 / inf
    assert np.isinf(want_s).any() and (want_s == (t if quant == "int4"
                                                  else 1)).any()
    a = torch.from_numpy(amax)

    def ref_int(x, am, qm, c, qu, w):
        return qref.chunk_quantize_shared_ref(x, am, qm, c,
                                              qops.QUANT_DTYPES[qu], w)

    for fn_int, fn_int4 in ((ref_int, qref.chunk_quantize_pack_shared_ref),
                            (qops.chunk_quantize_shared,
                             qops.chunk_quantize_pack_shared)):
        q, scales = _port(xt, a, qmax, chunk, quant, t, True, fn_int, fn_int4)
        width = h // 2 if quant == "int4" else h
        assert q.shape == (*lead, width) and scales.dtype == torch.float32
        np.testing.assert_array_equal(_bits(q), _bits(want_q))
        np.testing.assert_array_equal(_bits(scales), _bits(want_s))
        q2, none = _port(xt, a, qmax, chunk, quant, t, False, fn_int,
                         fn_int4)
        assert none is None
        np.testing.assert_array_equal(_bits(q2), _bits(q))


def test_shared_scale_quantize_takes_int8_and_fp8_only():
    with pytest.raises(ValueError, match="chunk_quantize_pack_shared"):
        qops.chunk_quantize_shared(torch.ones(2, 8), torch.ones(2, 1), 7.0,
                                   8, "int4")


# ---------------------------------------------------------------------------
# the quantized all-reduce through the new dispatch
# ---------------------------------------------------------------------------


def _parent_psum(xs, group, quant, chunk):
    """``quantized_psum_gathered`` as it ran before the scale moved into
    the quantize: the abs-max all-reduce, ``scales_from_amax``, the
    quantize onto those scales, the hops; (the gathered payload or the
    int4 result, the scales the dequantize takes)."""
    t = group.t
    amax = group.all_reduce([qref.chunk_amax_ref(x, chunk) for x in xs],
                            op="max")
    scales = qops.scales_from_amax(amax, qops.collective_qmax(quant, t))
    if quant == "int4":
        packed = [qref.chunk_quantize_pack_ref(x, scales, chunk) for x in xs]
        received = group.all_to_all(packed, values_per_item=2)
        reduced = [qref.nibble_reduce_requant_ref(p, t) for p in received]
        gathered = group.all_gather(reduced, values_per_item=2)
        return qref.nibble_unpack_dequantize_ref(gathered, scales * t, chunk,
                                                 xs[0].dtype), scales * t
    qs = [qref.chunk_quantize_ref(x, scales, chunk, qops.QUANT_DTYPES[quant])
          for x in xs]
    return group.all_gather(group.reduce_scatter(qs)), scales


@pytest.mark.parametrize("plain", [False, True], ids=["dispatch", "plain"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("quant", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("lead,h,chunk", [((2, 3), 256, 64), ((3,), 160, 64),
                                          ((2,), 200, 25)])
def test_quantized_psum_equals_the_parent_composition(lead, h, chunk, quant,
                                                      t, dtype, plain):
    rng = np.random.default_rng(h + t)
    xs = [torch.from_numpy(2.0 * rng.standard_normal((*lead, h))
                           .astype(np.float32)).to(dtype) for _ in range(t)]
    xs[1].reshape(-1, h)[0, :chunk] = 0.0      # one chunk zero on one rank
    for x in xs:
        x.reshape(-1, h)[-1, -chunk:] = 0.0    # one chunk zero on every rank
    want_group, got_group = comm.VirtualGroup(t), comm.VirtualGroup(t)
    with want_group.phase("decode"):
        want, want_s = _parent_psum(xs, want_group, quant, chunk)
    with got_group.phase("decode"):
        got = px.quantized_psum_gathered(xs, got_group, quant, chunk,
                                         plain=plain)
    assert got_group.log == want_group.log
    if quant == "int4":
        assert got.dtype == dtype
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        assert isinstance(got, px.GatheredSum) and got.plain == plain
        np.testing.assert_array_equal(_bits(got.q), _bits(want))
        np.testing.assert_array_equal(_bits(got.scales), _bits(want_s))
        assert (got.scales == 1.0).any()       # the all-zero chunk
        np.testing.assert_array_equal(
            _bits(px.quantized_psum(xs, comm.VirtualGroup(t), quant, chunk,
                                    plain=plain)),
            _bits(qref.chunk_dequantize_ref(want, want_s, chunk, dtype)))
