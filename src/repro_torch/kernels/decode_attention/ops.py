"""Dispatch for decode attention: kernels B3 (contiguous cache) and B4
(KV pages) on CUDA tensors, the plain versions on CPU tensors."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)

HEAD_DIMS = (32, 64, 128)
MAX_GROUPS = 8          # query heads per KV head the kernel holds


def decode_attention(q, k, v, lengths):
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths)
    return decode_attention_cuda(q, k, v, lengths)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths):
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          lengths)
    return paged_decode_attention_cuda(q, k_pages, v_pages, block_tables,
                                       lengths)


def _check_cache(name, t, what, dev, dt, shape):
    if t.device != dev or t.dtype != dt or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} is {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}, expected {dt} {tuple(shape)} on {dev}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: {what} needs a unit last-dim stride")


def _check_q(name, q, Hkv):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q on {q.device}, expected a CUDA device")
    B, Hq, D = q.shape
    if D not in HEAD_DIMS or Hq % Hkv or not 1 <= Hq // Hkv <= MAX_GROUPS:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}, or "
                         f"{Hq} query heads over {Hkv} KV heads")
    _build.require(name, "q", q, q.device, q.dtype)
    return B, Hq, D


def decode_attention_cuda(q, k, v, lengths):
    """Launch B3.  q [B,Hq,D] contiguous; k, v [B,W,Hkv,D] with a unit
    last-dim stride (any other strides, K and V alike); lengths [B] int32."""
    name = "decode_attention_cuda"
    W, Hkv = k.shape[1], k.shape[2]
    B, Hq, D = _check_q(name, q, Hkv)
    dev, dt = q.device, q.dtype
    _check_cache(name, k, "k", dev, dt, (B, W, Hkv, D))
    _check_cache(name, v, "v", dev, dt, (B, W, Hkv, D))
    if k.stride() != v.stride():
        raise ValueError(f"{name}: k and v strides differ")
    _build.require(name, "lengths", lengths, dev, torch.int32, (B,))
    code = _build.dtype_code(dt)
    out = torch.empty_like(q)
    sb, sw, sh, _ = k.stride()
    with torch.cuda.device(dev):
        rc = _build.lib().repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lengths.data_ptr(), B, W, Hkv, Hq // Hkv, D, sb, sw, sh,
            1.0 / math.sqrt(D), code, _build.stream_ptr(dev))
    _build.check(rc, name)
    _build.count("decode_attention")
    return out


def paged_decode_attention_cuda(q, k_pages, v_pages, block_tables, lengths):
    """Launch B4.  q [B,Hq,D] contiguous; k_pages, v_pages [P,ps,Hkv,D]
    read in place through their strides (unit last-dim stride, K and V
    alike); block_tables [B,n] and lengths [B] int32."""
    name = "paged_decode_attention_cuda"
    P, ps, Hkv = k_pages.shape[:3]
    B, Hq, D = _check_q(name, q, Hkv)
    dev, dt = q.device, q.dtype
    _check_cache(name, k_pages, "k_pages", dev, dt, (P, ps, Hkv, D))
    _check_cache(name, v_pages, "v_pages", dev, dt, (P, ps, Hkv, D))
    if k_pages.stride() != v_pages.stride():
        raise ValueError(f"{name}: k_pages and v_pages strides differ")
    n = block_tables.shape[1] if block_tables.dim() == 2 else -1
    _build.require(name, "block_tables", block_tables, dev, torch.int32,
                   (B, n))
    _build.require(name, "lengths", lengths, dev, torch.int32, (B,))
    code = _build.dtype_code(dt)
    out = torch.empty_like(q)
    sp, sr, sh, _ = k_pages.stride()
    with torch.cuda.device(dev):
        rc = _build.lib().repro_paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            out.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            B, P, ps, n, Hkv, Hq // Hkv, D, sp, sr, sh, 1.0 / math.sqrt(D),
            code, _build.stream_ptr(dev))
    _build.check(rc, name)
    _build.count("paged_decode_attention")
    return out
