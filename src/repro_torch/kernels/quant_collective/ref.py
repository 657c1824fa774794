"""Plain PyTorch versions of the per-chunk collective quantization ops:
the reference the quantized all-reduce's kernels are held to.

Counterpart of ``repro.kernels.quant_collective.ref``.  The quantized
two-step all-reduce (``core.parallel_exec.quantized_psum``) needs five
dense ops on the activation row entering a TP all-reduce:

* ``chunk_amax_ref``       (B5) abs-max over each ``chunk``-wide block,
* ``chunk_quantize_ref``   (B6) symmetric round-to-nearest-even onto the grid,
* ``nibble_pack_ref``      (B7) two int4 values per byte,
* ``nibble_unpack_ref``    (B8) the inverse, sign-extending each nibble,
* ``chunk_dequantize_ref`` (B9) back to the working dtype.

The all-reduce quantizes every rank's row onto the shared scales, which
``scales_from_amax`` makes from the all-reduced abs-max.  On the card that
rule runs inside B6: ``chunk_quantize_shared_ref`` (int8, fp8) and
``chunk_quantize_pack_shared_ref`` (int4) are ``scales_from_amax`` and the
quantize in one, and hand back the scales the dequantizing pass takes.

On the int8/fp8 wire the dequantize is followed by the residual add and
the next RMSNorm; ``dequantize_add_rms_norm_ref`` is that chain (B9, the
add, B1), which one kernel runs on the card.

The int4 wire runs them as three fused passes, each the composition of the
ops above (and of the JAX package's jnp requantize):

* ``chunk_quantize_pack_ref``      B6 (int8 grid) then B7, on every rank,
* ``nibble_reduce_requant_ref``    B8, the exact sum of the t source blocks,
  round(r / t) clipped to +-7, then B7, on every rank,
* ``nibble_unpack_dequantize_ref`` B8 then B9, once.

The hidden axis is zero-padded to a whole number of chunks and sliced
back, so ``h % chunk != 0`` is exact: the padding can neither raise an
abs-max nor leak into the output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm.ref import add_rms_norm_ref

FP8_MAX = 448.0            # finfo(float8_e4m3fn).max


def _pad_to_chunks(x, chunk: int):
    h = x.shape[-1]
    k = -(-h // chunk)
    pad = k * chunk - h
    if pad:
        x = F.pad(x, (0, pad))
    return x, k


def chunk_amax_ref(x, chunk: int):
    """Per-chunk abs-max of the last axis: [..., h] -> [..., K] float32.
    A NaN in a chunk gives NaN (``torch.amax`` propagates it, as
    ``jnp.max`` does)."""
    xp, k = _pad_to_chunks(x.float().abs(), chunk)
    return xp.reshape(*x.shape[:-1], k, chunk).amax(dim=-1)


def scales_from_amax(amax, qmax: float):
    """Per-chunk scale from the shared abs-max, 1.0 for all-zero chunks
    (and for a NaN abs-max: ``amax > 0`` is false).

    The JAX package writes ``amax / qmax``; XLA compiles a division by a
    constant as a multiply by its f32 reciprocal, which can land one f32
    ulp away.  The port computes what the compiled engine computes,
    ``amax * f32(1 / qmax)``, so its shared scales are bitwise the
    engine's; B6 computes the same product from ``inv_qmax``."""
    amax = amax.float()
    return torch.where(amax > 0.0, amax * inv_qmax(qmax),
                       torch.ones_like(amax))


def inv_qmax(qmax: float) -> float:
    """f32(1 / qmax), the reciprocal the shared scale multiplies by (a
    Python float holding the f32 value exactly)."""
    return (torch.tensor(1.0) / torch.tensor(float(qmax))).item()


def chunk_quantize_ref(x, scales, chunk: int, qdtype):
    """Symmetric quantize, q = x / scale per chunk: round half to even and
    clip to [-127, 127] for int8, clip to +-448 then round to e4m3 for
    ``torch.float8_e4m3fn``.  ``scales`` is [..., K] float32.

    Every zero scale is taken as 1, as the JAX package's Pallas kernel does
    (``quant_kernel.chunk_quantize_pallas``; its jnp reference divides by
    the zero).  ``scales_from_amax`` yields a zero scale only where
    amax * (1 / qmax) underflows."""
    h = x.shape[-1]
    xp, k = _pad_to_chunks(x.float(), chunk)
    s = torch.where(scales == 0, torch.ones_like(scales), scales)
    xc = xp.reshape(*x.shape[:-1], k, chunk) / s[..., None]
    if qdtype == torch.int8:
        xc = torch.clamp(torch.round(xc), -127.0, 127.0)
    elif qdtype == torch.float8_e4m3fn:
        xc = torch.clamp(xc, -FP8_MAX, FP8_MAX)
    else:
        raise TypeError(f"quantize targets int8 or float8_e4m3fn, got "
                        f"{qdtype}")
    return xc.reshape(*x.shape[:-1], k * chunk)[..., :h].to(qdtype)


def chunk_dequantize_ref(q, scales, chunk: int, out_dtype):
    """Dequantize, x = q * scale per chunk in f32, cast to ``out_dtype``."""
    h = q.shape[-1]
    qp, k = _pad_to_chunks(q.float(), chunk)
    xc = qp.reshape(*q.shape[:-1], k, chunk) * scales[..., None]
    return xc.reshape(*q.shape[:-1], k * chunk)[..., :h].to(out_dtype)


def dequantize_add_rms_norm_ref(q, scales, chunk: int, x, weight,
                                eps: float = 1e-5):
    """B9, the residual add and B1: (s, n) with d = chunk_dequantize_ref(q)
    in the type of x, s = x + d and n = rms_norm_ref(s)."""
    d = chunk_dequantize_ref(q, scales, chunk, x.dtype)
    return add_rms_norm_ref(x, d, weight, eps)


def nibble_pack_ref(q):
    """Pack int4 values (int8 storage, |q| <= 7) two per byte: [..., h] ->
    [..., h // 2] uint8.  Even positions land in the low nibble, odd ones in
    the high nibble (two's complement truncated to 4 bits)."""
    h = q.shape[-1]
    if h % 2:
        raise ValueError(f"nibble packing needs an even last axis, got {h}")
    u = q.to(torch.uint8)
    pairs = u.reshape(*q.shape[:-1], h // 2, 2)
    return (pairs[..., 0] & 0xF) | ((pairs[..., 1] & 0xF) << 4)


def nibble_unpack_ref(b):
    """Unpack two nibbles per byte back to int8: [..., m] -> [..., 2m],
    sign-extending each 4-bit field as ((n ^ 8) - 8)."""
    lo = (b & 0xF).to(torch.int8)
    hi = ((b >> 4) & 0xF).to(torch.int8)
    pairs = torch.stack([(lo ^ 8) - 8, (hi ^ 8) - 8], dim=-1)
    return pairs.reshape(*b.shape[:-1], b.shape[-1] * 2)


def chunk_quantize_pack_ref(x, scales, chunk: int):
    """The int4 pre-pass: B6 onto the int8 grid (round half to even, clip
    to +-127), then B7 keeps each value's low 4 bits: [..., h] (h even) ->
    [..., h // 2] uint8.  Each element takes its own chunk's scale."""
    return nibble_pack_ref(chunk_quantize_ref(x, scales, chunk, torch.int8))


def chunk_quantize_shared_ref(x, amax, qmax: float, chunk: int, qdtype,
                              write_scales: bool = False):
    """B6 onto the shared scales: ``scales_from_amax(amax, qmax)``, then
    ``chunk_quantize_ref``.  Returns (q, the scales when ``write_scales``,
    else None)."""
    scales = scales_from_amax(amax, qmax)
    q = chunk_quantize_ref(x, scales, chunk, qdtype)
    return q, (scales if write_scales else None)


def chunk_quantize_pack_shared_ref(x, amax, qmax: float, chunk: int,
                                   t: int = 1, write_scales: bool = False):
    """The int4 pre-pass onto the shared scales: ``scales_from_amax``, then
    ``chunk_quantize_pack_ref``.  Returns (packed, the scales times t when
    ``write_scales``, else None): what ``nibble_unpack_dequantize`` takes
    after the reduce has requantized the sum of t ranks by t."""
    scales = scales_from_amax(amax, qmax)
    packed = chunk_quantize_pack_ref(x, scales, chunk)
    return packed, (scales * t if write_scales else None)


def nibble_reduce_requant_ref(packed, t: int):
    """The int4 reduce on one rank: ``packed`` [..., m] uint8 holds the t
    source ranks' copies of this rank's block (m / t bytes each, rank
    order, as the all-to-all delivers them).  Their values are summed
    exactly in int32, requantized as round(r / t) (half to even) clipped
    to +-7, and packed: [..., m // t] uint8."""
    lead, m = packed.shape[:-1], packed.shape[-1]
    if t < 1 or m % t:
        raise ValueError(f"the last axis holds t={t} packed blocks: {m} "
                         f"bytes must divide (h % 2t == 0)")
    r = nibble_unpack_ref(packed).to(torch.int32).reshape(
        *lead, t, 2 * m // t).sum(dim=-2)                # exact: |r| <= 8t
    rq = torch.clamp(torch.round(r.float() / t), -7, 7)
    return nibble_pack_ref(rq.to(torch.int8))


def nibble_unpack_dequantize_ref(b, scales, chunk: int, out_dtype):
    """The int4 post-pass: B8 then B9, [..., m] uint8 and f32 scales
    [..., K] over h = 2m -> ``out_dtype`` [..., 2m]."""
    return chunk_dequantize_ref(nibble_unpack_ref(b), scales, chunk,
                                out_dtype)
