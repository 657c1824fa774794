"""Dispatch and numerics contract of the quantized collectives.

``chunk_amax`` (B5), ``chunk_quantize`` (B6), ``chunk_dequantize`` (B9),
the int8/fp8 wire's ``dequantize_add_rms_norm`` (B9, the residual add and
the RMSNorm after it, B1), and the int4 wire's three fused passes,
``chunk_quantize_pack`` (B6 + B7), ``nibble_reduce_requant`` (B8, exact
sum, requantize, B7) and ``nibble_unpack_dequantize`` (B8 + B9), launch
their CUDA kernel on a CUDA tensor and run the plain version on a CPU
tensor; a ``*_cuda`` wrapper raises on anything its kernel does not take.

B6 is one kernel template over the wire (int8, fp8, int4 packed two a
byte) and over the source of its scale:

* the scales themselves (``chunk_quantize``, ``chunk_quantize_pack``), a
  zero scale taken as 1 as the JAX package's Pallas wrapper does;
* the all-reduced abs-max and ``qmax`` (``chunk_quantize_shared``,
  ``chunk_quantize_pack_shared``): the kernel computes
  ``scales_from_amax`` itself, bit for bit, and on request writes the
  scales (times t on int4) for the dequantizing pass, so nothing runs
  between the abs-max's all-reduce and the quantize.

The numerics contract is a copy of ``repro.kernels.quant_collective.ops``
with torch dtypes (the port imports nothing of the JAX package):

* ``QUANT_DTYPES``     wire modes and their payload dtypes,
* ``collective_qmax``  the per-rank quant ceiling with summation headroom
  (``floor(127/t)`` for int8, ``448/t`` for fp8-e4m3, the full +-7 for
  int4), so the t-way sum cannot overflow the wire dtype,
* ``scales_from_amax`` the shared scale from the all-reduced abs-max, 1.0
  where a chunk is all zeros (``ref.py``, re-exported here),
* ``QUANT_TOLERANCE``  the accuracy contract per mode: greedy token match
  against the unquantized path >= ``token_match_floor`` and max logit
  drift <= ``logit_drift_ceiling``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_collective.ref import (  # noqa: F401
    chunk_amax_ref, chunk_dequantize_ref, chunk_quantize_pack_ref,
    chunk_quantize_pack_shared_ref, chunk_quantize_ref,
    chunk_quantize_shared_ref, dequantize_add_rms_norm_ref, inv_qmax,
    nibble_reduce_requant_ref, nibble_unpack_dequantize_ref,
    scales_from_amax)

# int4 has no torch dtype: its values lie on the int8 grid (|q| <= 7) and
# travel packed two per uint8 byte; the fused int4 passes pack and unpack
# them without an int8 tensor in between.
QUANT_DTYPES = {
    "int8": torch.int8,
    "fp8": torch.float8_e4m3fn,
    "int4": torch.int8,
}

DEFAULT_CHUNK = 128

# The tested accuracy contract per wire mode, measured teacher-forced
# against the unquantized path (the JAX package's numbers, unchanged).
# Calibrated on reduced configs with random weights (near-worst-case logit
# margins; drift compounds through 32 steps of quantized KV-cache
# history): worst observed int8 row token_match 0.9375 / drift 0.172 at
# t=4, fp8 0.906 / 0.145 at t=2, so the ceilings carry ~1.5-2x headroom.
# int8 with summation headroom keeps per-element relative error ~2^-7;
# fp8-e4m3 carries ~2^-3 mantissa steps, hence the looser row.
QUANT_TOLERANCE = {
    "int8": {"token_match_floor": 0.90, "logit_drift_ceiling": 0.25},
    "fp8": {"token_match_floor": 0.75, "logit_drift_ceiling": 0.30},
    # int4 keeps the full +-7 grid (the packed all-to-all sums exactly in
    # int32) but requantizes the reduced row back onto the 4-bit grid
    # before the gather, so per-all-reduce error is bounded by t * amax/7
    # and grows with the TP degree.  The contract only pins that the
    # 4-bit wire does not silently get worse.
    "int4": {"token_match_floor": 0.25, "logit_drift_ceiling": 2.0},
}


def collective_qmax(quant: str, t: int) -> float:
    """Per-rank quant ceiling with headroom for an exact t-way sum.

    Each rank quantizes with the shared (all-reduced) per-chunk abs-max,
    so every |q| <= qmax; capping qmax at ``range/t`` bounds the
    reduce-scatter's partial sum by the wire dtype's max.  int4 keeps the
    full +-7 (``floor(7/t)`` would collapse the grid at t >= 4): its
    all-to-all ships every rank's nibbles unsummed, every rank sums its
    block exactly in int32, and only the requantize-by-t rounds.
    """
    if quant not in QUANT_DTYPES:
        raise ValueError(f"unknown quant mode {quant!r}; "
                         f"expected one of {sorted(QUANT_DTYPES)}")
    if t < 1:
        raise ValueError(f"t must be >= 1, got {t}")
    if quant == "int8":
        return float(127 // t)
    if quant == "int4":
        return 7.0
    return 448.0 / t


# ---------------------------------------------------------------------------
# dispatch: the plain version on a CPU tensor, the kernel on a CUDA tensor
# ---------------------------------------------------------------------------


def chunk_amax(x, chunk: int = DEFAULT_CHUNK):
    if x.device.type == "cpu":
        return chunk_amax_ref(x, chunk)
    return chunk_amax_cuda(x, chunk)


def chunk_quantize(x, scales, chunk: int = DEFAULT_CHUNK,
                   quant: str = "int8"):
    qdtype = QUANT_DTYPES[quant]
    if x.device.type == "cpu":
        return chunk_quantize_ref(x, scales, chunk, qdtype)
    return chunk_quantize_cuda(x, scales, chunk, qdtype)


def chunk_quantize_shared(x, amax, qmax: float, chunk: int = DEFAULT_CHUNK,
                          quant: str = "int8", write_scales: bool = False):
    """int8/fp8 B6 from the all-reduced abs-max [..., K]: (q, the shared
    scales f32 [..., K] when ``write_scales``, else None)."""
    qdtype = _wire_dtype(quant)
    if x.device.type == "cpu":
        return chunk_quantize_shared_ref(x, amax, qmax, chunk, qdtype,
                                         write_scales)
    return chunk_quantize_shared_cuda(x, amax, qmax, chunk, qdtype,
                                      write_scales)


def chunk_dequantize(q, scales, chunk: int = DEFAULT_CHUNK,
                     out_dtype=torch.float32):
    if q.device.type == "cpu":
        return chunk_dequantize_ref(q, scales, chunk, out_dtype)
    return chunk_dequantize_cuda(q, scales, chunk, out_dtype)


def dequantize_add_rms_norm(q, scales, chunk: int, x, weight,
                            eps: float = 1e-5):
    """int8/fp8 post-pass with the residual add and the next norm: (s, n),
    s = x + chunk_dequantize(q) in x's type, n = rms_norm(s)."""
    if q.device.type == "cpu":
        return dequantize_add_rms_norm_ref(q, scales, chunk, x, weight, eps)
    return dequantize_add_rms_norm_cuda(q, scales, chunk, x, weight, eps)


def chunk_quantize_pack(x, scales, chunk: int = DEFAULT_CHUNK):
    """int4 pre-pass: quantize onto the int8 grid, pack the low nibbles:
    [..., h] -> uint8 [..., h // 2]."""
    if x.device.type == "cpu":
        return chunk_quantize_pack_ref(x, scales, chunk)
    return chunk_quantize_pack_cuda(x, scales, chunk)


def chunk_quantize_pack_shared(x, amax, qmax: float,
                               chunk: int = DEFAULT_CHUNK, t: int = 1,
                               write_scales: bool = False):
    """int4 pre-pass from the all-reduced abs-max: (packed uint8
    [..., h // 2], the shared scales times t when ``write_scales``, else
    None)."""
    if x.device.type == "cpu":
        return chunk_quantize_pack_shared_ref(x, amax, qmax, chunk, t,
                                              write_scales)
    return chunk_quantize_pack_shared_cuda(x, amax, qmax, chunk, t,
                                           write_scales)


def nibble_reduce_requant(packed, t: int):
    """int4 reduce: t packed source blocks [..., m] -> their requantized
    sum, uint8 [..., m // t]."""
    if packed.device.type == "cpu":
        return nibble_reduce_requant_ref(packed, t)
    return nibble_reduce_requant_cuda(packed, t)


def nibble_unpack_dequantize(b, scales, chunk: int = DEFAULT_CHUNK,
                             out_dtype=torch.float32):
    """int4 post-pass: uint8 [..., m] -> ``out_dtype`` [..., 2m]."""
    if b.device.type == "cpu":
        return nibble_unpack_dequantize_ref(b, scales, chunk, out_dtype)
    return nibble_unpack_dequantize_cuda(b, scales, chunk, out_dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

FLOAT_TYPES = _build.FLOAT_TYPES
WIRE_TYPES = (torch.int8, torch.float8_e4m3fn)
# B6's wire modes: int8 and fp8 by their dtype codes, int4 (the int8
# value's low nibble, two a byte) as kNibble in quant_collective.cu
_NIBBLE = 5


def _wire_dtype(quant: str):
    """The 1-byte wire dtype of an int8/fp8 mode (int4 packs: see
    ``chunk_quantize_pack_shared``)."""
    if quant not in ("int8", "fp8"):
        raise ValueError(f"chunk_quantize_shared takes quant 'int8' or "
                         f"'fp8', got {quant!r} (int4: "
                         "chunk_quantize_pack_shared)")
    return QUANT_DTYPES[quant]


def _check_input(name, x, dtypes):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x on {x.device}, expected a CUDA device")
    _build.require(name, "x", x, x.device, x.dtype)
    if x.numel() == 0:
        raise ValueError(f"{name}: x is empty")
    return _build.dtype_code(x.dtype, dtypes)


def _check_scales(name, x, scales, chunk, h=None, what="scales"):
    """``what`` [..., K] f32 over x's rows, K chunks of an h-wide row (h:
    x's last axis unless given)."""
    if chunk < 1:
        raise ValueError(f"{name}: chunk must be >= 1, got {chunk}")
    k = -(-(x.shape[-1] if h is None else h) // chunk)
    _build.require(name, what, scales, x.device, torch.float32,
                   (*x.shape[:-1], k))


def chunk_amax_cuda(x, chunk: int = DEFAULT_CHUNK):
    """Launch B5 on x [..., h] (float32 or bfloat16): f32 [..., K]."""
    name = "chunk_amax_cuda"
    code = _check_input(name, x, FLOAT_TYPES)
    if chunk < 1:
        raise ValueError(f"{name}: chunk must be >= 1, got {chunk}")
    h = x.shape[-1]
    out = torch.empty((*x.shape[:-1], -(-h // chunk)), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.lib().repro_chunk_amax(
            x.data_ptr(), out.data_ptr(), x.numel() // h, h, chunk, code,
            _build.stream_ptr(x.device))
    _build.check(rc, name)
    _build.count("chunk_amax")
    return out


def _quantize(name, x, src, chunk, mode, out, count, from_amax=False,
              qmax=None, mult=1.0, write_scales=False):
    """Launch B6 (``repro_chunk_quantize``) on x [..., h] into ``out``:
    ``src`` holds the scales, or with ``from_amax`` the all-reduced
    abs-max (then ``qmax`` is given); returns the scales times ``mult``
    [..., K] when ``write_scales``, else None."""
    code = _check_input(name, x, FLOAT_TYPES)
    _check_scales(name, x, src, chunk, what="amax" if from_amax else "scales")
    scales = torch.empty_like(src) if write_scales else None
    h = x.shape[-1]
    with torch.cuda.device(x.device):
        rc = _build.lib().repro_chunk_quantize(
            x.data_ptr(), src.data_ptr(),
            scales.data_ptr() if write_scales else None, out.data_ptr(),
            x.numel() // h, h, chunk, int(from_amax),
            inv_qmax(qmax) if from_amax else 0.0, float(mult), code, mode,
            _build.stream_ptr(x.device))
    _build.check(rc, name)
    _build.count(count)
    return scales


def chunk_quantize_cuda(x, scales, chunk: int = DEFAULT_CHUNK,
                        qdtype=torch.int8):
    """Launch B6: x [..., h] (float32 or bfloat16) and f32 scales
    [..., K] -> ``qdtype`` (int8 or float8_e4m3fn) [..., h]."""
    mode = _build.dtype_code(qdtype, WIRE_TYPES)
    out = torch.empty(x.shape, dtype=qdtype, device=x.device)
    _quantize("chunk_quantize_cuda", x, scales, chunk, mode, out,
              "chunk_quantize")
    return out


def chunk_quantize_shared_cuda(x, amax, qmax: float,
                               chunk: int = DEFAULT_CHUNK, qdtype=torch.int8,
                               write_scales: bool = False):
    """Launch B6 from the all-reduced abs-max: x [..., h] (float32 or
    bfloat16) and f32 amax [..., K] -> (``qdtype`` [..., h], f32 scales
    [..., K] or None); every scale is ``scales_from_amax(amax, qmax)``,
    computed in the kernel."""
    mode = _build.dtype_code(qdtype, WIRE_TYPES)
    out = torch.empty(x.shape, dtype=qdtype, device=x.device)
    scales = _quantize("chunk_quantize_shared_cuda", x, amax, chunk, mode,
                       out, "chunk_quantize", from_amax=True, qmax=qmax,
                       write_scales=write_scales)
    return out, scales


def chunk_dequantize_cuda(q, scales, chunk: int = DEFAULT_CHUNK,
                          out_dtype=torch.float32):
    """Launch B9: q [..., h] (int8 or float8_e4m3fn) and f32 scales
    [..., K] -> ``out_dtype`` (float32 or bfloat16) [..., h]."""
    name = "chunk_dequantize_cuda"
    qcode = _check_input(name, q, WIRE_TYPES)
    _check_scales(name, q, scales, chunk)
    code = _build.dtype_code(out_dtype, FLOAT_TYPES)
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    h = q.shape[-1]
    with torch.cuda.device(q.device):
        rc = _build.lib().repro_chunk_dequantize(
            q.data_ptr(), scales.data_ptr(), out.data_ptr(), q.numel() // h,
            h, chunk, qcode, code, _build.stream_ptr(q.device))
    _build.check(rc, name)
    _build.count("chunk_dequantize")
    return out


def dequantize_add_rms_norm_cuda(q, scales, chunk: int, x, weight,
                                 eps: float = 1e-5):
    """Launch B9 + residual add + B1 fused: q [..., h] (int8 or
    float8_e4m3fn), f32 scales [..., K], x [..., h] (float32 or bfloat16)
    and weight [h] of x's type -> (s, n), new [..., h] of x's type; all
    contiguous.  Pointers off a 16-byte boundary (q off an 8-byte one for
    bf16, 4 for f32) take the kernel's element path."""
    name = "dequantize_add_rms_norm_cuda"
    qcode = _check_input(name, q, WIRE_TYPES)
    _check_scales(name, q, scales, chunk)
    code = _check_input(name, x, FLOAT_TYPES)
    if x.device != q.device or x.shape != q.shape:
        raise ValueError(f"{name}: x is {tuple(x.shape)} on {x.device}, q "
                         f"{tuple(q.shape)} on {q.device}")
    h = x.shape[-1]
    _build.require(name, "weight", weight, x.device, x.dtype, (h,))
    s = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    n = torch.empty_like(s)
    with torch.cuda.device(x.device):
        rc = _build.lib().repro_dequantize_add_rmsnorm(
            q.data_ptr(), scales.data_ptr(), x.data_ptr(), weight.data_ptr(),
            s.data_ptr(), n.data_ptr(), x.numel() // h, h, chunk, float(eps),
            qcode, code, _build.stream_ptr(x.device))
    _build.check(rc, name)
    _build.count("dequantize_add_rms_norm")
    return s, n


def _packed_out(name, x):
    h = x.shape[-1]
    if h % 2:
        raise ValueError(f"{name}: nibble packing needs an even last axis, "
                         f"got {h}")
    return torch.empty((*x.shape[:-1], h // 2), dtype=torch.uint8,
                       device=x.device)


def chunk_quantize_pack_cuda(x, scales, chunk: int = DEFAULT_CHUNK):
    """Launch B6 + B7 fused: x [..., h] (float32 or bfloat16, h even) and
    f32 scales [..., K] -> uint8 [..., h // 2]."""
    name = "chunk_quantize_pack_cuda"
    _check_input(name, x, FLOAT_TYPES)
    out = _packed_out(name, x)
    _quantize(name, x, scales, chunk, _NIBBLE, out, "chunk_quantize_pack")
    return out


def chunk_quantize_pack_shared_cuda(x, amax, qmax: float,
                                    chunk: int = DEFAULT_CHUNK, t: int = 1,
                                    write_scales: bool = False):
    """Launch B6 + B7 fused from the all-reduced abs-max: x [..., h]
    (float32 or bfloat16, h even) and f32 amax [..., K] -> (uint8
    [..., h // 2], f32 scales times t [..., K] or None)."""
    name = "chunk_quantize_pack_shared_cuda"
    _check_input(name, x, FLOAT_TYPES)
    out = _packed_out(name, x)
    scales = _quantize(name, x, amax, chunk, _NIBBLE, out,
                       "chunk_quantize_pack", from_amax=True, qmax=qmax,
                       mult=float(t), write_scales=write_scales)
    return out, scales


def nibble_reduce_requant_cuda(packed, t: int):
    """Launch B8 + exact sum + requantize + B7 fused: uint8 [..., m], t
    blocks of m / t bytes -> uint8 [..., m // t]."""
    name = "nibble_reduce_requant_cuda"
    _check_input(name, packed, (torch.uint8,))
    m = packed.shape[-1]
    if t < 1 or m % t:
        raise ValueError(f"{name}: the last axis holds t={t} packed blocks: "
                         f"{m} bytes must divide (h % 2t == 0)")
    out = torch.empty((*packed.shape[:-1], m // t), dtype=torch.uint8,
                      device=packed.device)
    with torch.cuda.device(packed.device):
        rc = _build.lib().repro_nibble_reduce_requant(
            packed.data_ptr(), out.data_ptr(), packed.numel() // m, m // t,
            t, _build.stream_ptr(packed.device))
    _build.check(rc, name)
    _build.count("nibble_reduce_requant")
    return out


def nibble_unpack_dequantize_cuda(b, scales, chunk: int = DEFAULT_CHUNK,
                                  out_dtype=torch.float32):
    """Launch B8 + B9 fused: uint8 [..., m] and f32 scales [..., K] over
    h = 2m -> ``out_dtype`` (float32 or bfloat16) [..., 2m]."""
    name = "nibble_unpack_dequantize_cuda"
    _check_input(name, b, (torch.uint8,))
    m = b.shape[-1]
    _check_scales(name, b, scales, chunk, h=2 * m)
    code = _build.dtype_code(out_dtype, FLOAT_TYPES)
    out = torch.empty((*b.shape[:-1], 2 * m), dtype=out_dtype,
                      device=b.device)
    with torch.cuda.device(b.device):
        rc = _build.lib().repro_nibble_unpack_dequantize(
            b.data_ptr(), scales.data_ptr(), out.data_ptr(), b.numel() // m,
            m, chunk, code, _build.stream_ptr(b.device))
    _build.check(rc, name)
    _build.count("nibble_unpack_dequantize")
    return out


_GRID_KERNELS = {"chunk_amax": (0, 0), "chunk_quantize": (1, 2),
                 "chunk_quantize_pack": (1, _NIBBLE)}


def quant_grid_cuda(kernel: str, x, chunk: int = DEFAULT_CHUNK,
                    launch: bool = False):
    """The launch grid (blocks in x, blocks in y, threads a block) of
    ``kernel`` (B5 ``chunk_amax``, B6 ``chunk_quantize`` or
    ``chunk_quantize_pack``) on x; with ``launch``, an empty kernel runs
    at that grid on the current stream, launched as B5 and B6 are (by
    programmatic dependent launch, waiting for its predecessor): the
    grid's own launch cost, which ``chip_smoke.py`` times beside the
    kernels (not a kernel of any path: it counts no launch)."""
    name = "quant_grid_cuda"
    code = _check_input(name, x, FLOAT_TYPES)
    which, mode = _GRID_KERNELS[kernel]
    h = x.shape[-1]
    grid = (ctypes.c_int * 3)()
    with torch.cuda.device(x.device):
        rc = _build.lib().repro_quant_grid(
            x.data_ptr(), which, x.numel() // h, h, chunk, code, mode,
            int(launch), grid, _build.stream_ptr(x.device))
    _build.check(rc, name)
    return tuple(grid)
