"""The port's quantized collectives against the JAX package.

* The plain versions of B5–B9 (``repro_torch.kernels.quant_collective.ref``,
  what the CUDA kernels are held to bit for bit on the card) against the
  JAX package's Pallas kernels run with ``interpret=True``: bitwise, on an
  even and a ragged (h = 160, chunk = 64) hidden width, and on every int4
  nibble value.
* The numerics contract copied into ``ops.py``: equal to the JAX one,
  the shared scales bitwise as the compiled JAX engine computes them.
* ``quantized_psum`` on virtual ranks against JAX's ``px.quantized_psum``
  under ``shard_map`` at t in {2, 4}: for int8 and int4 the recovered
  integer payload is bitwise equal and the output within 2e-6 (the f32
  dequantize multiply in the two frameworks); for fp8 the output is
  bitwise at t = 2, and at t = 4 the summed payload lies within one e4m3
  step (the port adds the t payloads in f32 and rounds once; XLA's ring
  may round after each add).

Inputs come from seeded numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import parallel_exec as jpx  # noqa: E402
from repro.kernels.quant_collective import ops as jops  # noqa: E402
from repro.kernels.quant_collective.quant_kernel import (  # noqa: E402
    chunk_amax_pallas, chunk_dequantize_pallas, chunk_quantize_pallas,
    nibble_pack_pallas, nibble_unpack_pallas)
from repro_torch.core import comm  # noqa: E402
from repro_torch.core import commodel as port_cm  # noqa: E402
from repro_torch.core.parallel_exec import quantized_psum  # noqa: E402
from repro_torch.kernels.quant_collective import ops as qops  # noqa: E402
from repro_torch.kernels.quant_collective import ref as qref  # noqa: E402

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 host-platform devices")

WIRE = {"int8": (jnp.int8, torch.int8),
        "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
SHAPES = [pytest.param((4, 3072), 128, id="decode-row"),
          pytest.param((3, 160), 64, id="ragged-160-64"),
          pytest.param((2, 5, 257), 128, id="odd-h")]


def _x(shape, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _bytes(a):
    """Raw bytes of a numpy array or a torch tensor, for bitwise checks."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view(torch.uint8).numpy() if a.element_size() == 1 \
            else a.numpy().view(np.uint8)
    return np.ascontiguousarray(a).view(np.uint8)


# ---------------------------------------------------------------------------
# plain B5–B9 against the Pallas kernels (interpret mode), bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,chunk", SHAPES)
def test_chunk_amax_plain_equals_pallas(shape, chunk):
    x = _x(shape)
    x.reshape(-1)[7] = -50.0                     # a negative abs-max
    want = np.asarray(chunk_amax_pallas(jnp.asarray(x), chunk=chunk,
                                        interpret=True))
    got = qref.chunk_amax_ref(torch.from_numpy(x), chunk)
    np.testing.assert_array_equal(_bytes(got), _bytes(want))


@pytest.mark.parametrize("quant", ["int8", "fp8"])
@pytest.mark.parametrize("shape,chunk", SHAPES)
def test_chunk_quantize_and_dequantize_plain_equal_pallas(shape, chunk,
                                                          quant):
    """Scales tight enough that both clips bind (|x/s| up to ~4x the int8
    range, past 448 for fp8), one zero scale (taken as 1 by both), and
    the dequantize back to f32."""
    jdt, tdt = WIRE[quant]
    x = _x(shape, seed=1)
    amax = np.asarray(chunk_amax_pallas(jnp.asarray(x), chunk=chunk,
                                        interpret=True))
    scales = np.where(amax > 0, amax / 31.0, 1.0).astype(np.float32)
    if quant == "fp8":
        scales = scales / 16.0
    scales.reshape(-1)[0] = 0.0
    want = np.asarray(chunk_quantize_pallas(
        jnp.asarray(x), jnp.asarray(scales), chunk=chunk, qdtype=jdt,
        interpret=True))
    got = qref.chunk_quantize_ref(torch.from_numpy(x),
                                  torch.from_numpy(scales), chunk, tdt)
    np.testing.assert_array_equal(_bytes(got), _bytes(want))
    want_x = np.asarray(chunk_dequantize_pallas(
        jnp.asarray(want), jnp.asarray(scales), chunk=chunk,
        out_dtype=jnp.float32, interpret=True))
    got_x = qref.chunk_dequantize_ref(got, torch.from_numpy(scales), chunk,
                                      torch.float32)
    np.testing.assert_array_equal(got_x.numpy(), want_x)


def test_round_half_to_even_and_clip_like_pallas():
    """Ties round to even (not away from zero), and the int8 clip is
    [-127, 127]: x/s = 0.5, 1.5, 2.5, -2.5, 200, -200."""
    x = np.array([[0.5, 1.5, 2.5, -2.5, 200.0, -200.0, 0.0, 3.0]],
                 np.float32)
    s = np.ones((1, 1), np.float32)
    want = np.asarray(chunk_quantize_pallas(jnp.asarray(x), jnp.asarray(s),
                                            chunk=8, qdtype=jnp.int8,
                                            interpret=True))
    got = qref.chunk_quantize_ref(torch.from_numpy(x), torch.from_numpy(s),
                                  8, torch.int8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [[0, 2, 2, -2, 127, -127, 0, 3]]


def test_nibbles_plain_equal_pallas_for_every_value():
    v = np.arange(-8, 8, dtype=np.int8)
    pairs = np.stack(np.meshgrid(v, v, indexing="ij"), -1).reshape(2, -1)
    want = np.asarray(nibble_pack_pallas(jnp.asarray(pairs), interpret=True))
    got = qref.nibble_pack_ref(torch.from_numpy(pairs))
    np.testing.assert_array_equal(got.numpy(), want)
    every = np.arange(256, dtype=np.uint8).reshape(4, 64)
    want = np.asarray(nibble_unpack_pallas(jnp.asarray(every),
                                           interpret=True))
    got = qref.nibble_unpack_ref(torch.from_numpy(every))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        qref.nibble_unpack_ref(qref.nibble_pack_ref(
            torch.from_numpy(pairs))).numpy(), pairs)
    with pytest.raises(ValueError, match="even"):
        qref.nibble_pack_ref(torch.zeros(2, 3, dtype=torch.int8))


def test_numerics_contract_copy_agrees():
    assert qops.QUANT_TOLERANCE == jops.QUANT_TOLERANCE
    assert qops.DEFAULT_CHUNK == jops.DEFAULT_CHUNK \
        == port_cm.DEFAULT_QUANT_CHUNK
    assert set(qops.QUANT_DTYPES) == set(jops.QUANT_DTYPES)
    for quant in qops.QUANT_DTYPES:
        for t in (1, 2, 3, 4, 8):
            assert qops.collective_qmax(quant, t) == \
                jops.collective_qmax(quant, t)
    # the scales as the compiled engine computes them (constant qmax)
    amax = np.abs(_x((64, 32), seed=5)).astype(np.float32)
    amax[0, :4] = 0.0
    for qmax in (127.0, 63.0, 31.0, 224.0, 112.0, 7.0):
        want = jax.jit(lambda a, q=qmax: jops.scales_from_amax(a, q))(
            jnp.asarray(amax))
        np.testing.assert_array_equal(
            qops.scales_from_amax(torch.from_numpy(amax), qmax).numpy(),
            np.asarray(want))
    with pytest.raises(ValueError, match="unknown quant"):
        qops.collective_qmax("int2", 2)


# ---------------------------------------------------------------------------
# quantized_psum against the JAX two-step under shard_map
# ---------------------------------------------------------------------------


def _jax_quantized_psum(x_ranks, t, quant, chunk):
    fn = jax.jit(shard_map(
        lambda xs: jpx.quantized_psum(xs, "tp", t, quant=quant, chunk=chunk),
        mesh=jpx.make_tp_mesh(t), in_specs=P("tp"), out_specs=P("tp"),
        check_rep=False))
    out = np.asarray(fn(jnp.asarray(x_ranks)))
    return out[0]


def _port_quantized_psum(x_ranks, t, quant, chunk, group=None):
    group = group or comm.VirtualGroup(t)
    xs = [torch.from_numpy(x_ranks[r]) for r in range(t)]
    return quantized_psum(xs, group, quant, chunk).numpy()


def _shared_scales(x_ranks, t, quant, chunk):
    amax = qref.chunk_amax_ref(torch.from_numpy(x_ranks), chunk).amax(dim=0)
    return qops.scales_from_amax(amax, qops.collective_qmax(quant, t))


def _payload(out, scales, chunk, h):
    """The summed quantized payload a dequantized output carries."""
    s = np.repeat(scales.numpy(), chunk, axis=-1)[..., :h]
    return out / s


def _e4m3_step(v):
    """One e4m3 step at magnitude |v| (3 mantissa bits, subnormal floor)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -6)))
    return 2.0 ** (e - 3)


@needs_mesh
@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("quant", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("h,chunk", [(256, 128), (160, 64)])
def test_quantized_psum_matches_jax(t, quant, h, chunk):
    if quant == "int4" and h % (2 * t):
        pytest.skip("int4 needs h % 2t == 0")
    x = _x((t, 3, h), seed=t, scale=2.0)
    want = _jax_quantized_psum(x, t, quant, chunk)
    got = _port_quantized_psum(x, t, quant, chunk)
    scales = _shared_scales(x, t, quant, chunk)
    if quant == "int4":
        scales = scales * t
    pw, pg = _payload(want, scales, chunk, h), _payload(got, scales, chunk, h)
    if quant in ("int8", "int4"):
        np.testing.assert_array_equal(np.rint(pg), np.rint(pw))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    elif t == 2:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(pg - pw) <= _e4m3_step(np.maximum(
            np.abs(pg), np.abs(pw))) * (1 + 1e-6))


def test_quantized_psum_logs_the_two_step():
    """One call logs the rows ``commodel.quant_decode_ar_ops`` predicts for
    one quantized all-reduce: an f32 [rows, K] max all-reduce and the two
    payload hops (reduce-scatter + all-gather, or all-to-all + all-gather
    at half a byte for int4)."""
    t, h, chunk = 4, 256, 64
    x = _x((t, 3, h), seed=9)
    for quant in ("int8", "fp8", "int4"):
        group = comm.VirtualGroup(t)
        with group.phase("decode"):
            _port_quantized_psum(x, t, quant, chunk, group)
        want = port_cm.quant_decode_ar_ops("decode", 1, 3, h, t, quant,
                                           chunk)
        assert comm.fold(group.summary()) == comm.fold(want)


def test_quantized_psum_degenerate_and_invalid_cases():
    x = _x((2, 3, 12), seed=3)
    plain = comm.VirtualGroup(2)
    np.testing.assert_array_equal(
        _port_quantized_psum(x, 2, None, 4, plain), x[0] + x[1])
    assert [r.kind for r in plain.log] == ["allreduce"]
    one = comm.VirtualGroup(1)
    np.testing.assert_array_equal(
        _port_quantized_psum(x[:1], 1, "int8", 4, one), x[0])
    assert one.log == []
    with pytest.raises(ValueError, match="must divide"):
        _port_quantized_psum(_x((4, 2, 10)), 4, "int8", 4)
    with pytest.raises(ValueError, match="2t"):
        _port_quantized_psum(_x((4, 2, 12)), 4, "int4", 4)


def test_virtual_group_collectives_follow_lax_semantics():
    """reduce_scatter / all_gather / all_to_all tiled over the last axis,
    sums in rank order, and the max all-reduce keeping a NaN."""
    t = 3
    xs = [torch.arange(6.0).reshape(1, 6) + 10 * r for r in range(t)]
    g = comm.VirtualGroup(t)
    total = xs[0] + xs[1] + xs[2]
    assert torch.equal(g.all_reduce(xs), total)
    rs = g.reduce_scatter(xs)
    assert [b.tolist() for b in rs] == [total[:, 2 * r:2 * r + 2].tolist()
                                        for r in range(t)]
    assert torch.equal(g.all_gather(rs), total)
    a2a = g.all_to_all(xs)
    for dst in range(t):
        want = torch.cat([xs[src][:, 2 * dst:2 * dst + 2]
                          for src in range(t)], dim=-1)
        assert torch.equal(a2a[dst], want)
    xs[1][0, 3] = float("nan")
    assert g.all_reduce(xs, op="max")[0, 3].isnan()
    fp8 = [torch.full((1, 3), 1.125).to(torch.float8_e4m3fn)] * t
    out = g.reduce_scatter(fp8)
    assert out[0].dtype == torch.float8_e4m3fn
    assert out[0].float().item() == 3.5     # 3.375 rounded once to e4m3
    assert [r.kind for r in g.log] == ["allreduce", "reducescatter",
                                       "allgather", "alltoall", "allreduce",
                                       "reducescatter"]
    with pytest.raises(ValueError, match="ranks"):
        g.all_reduce(xs[:2])
