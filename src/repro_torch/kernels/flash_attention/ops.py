"""Dispatch for prefill attention: kernel B2 on a CUDA tensor, the plain
version on a CPU tensor."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (32, 64, 128)


def flash_attention(q, k, v, q_offset, kv_len, window=None):
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_offset, kv_len, window)
    return flash_attention_cuda(q, k, v, q_offset, kv_len, window)


def flash_attention_cuda(q, k, v, q_offset, kv_len, window=None):
    """Launch B2.  q [B,S,Hq,D]; k, v [B,T,Hkv,D]; q_offset, kv_len [B]
    int32 — all contiguous on one CUDA device."""
    name = "flash_attention_cuda"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q on {q.device}, expected a CUDA device")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS or Hq % Hkv:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS} or "
                         f"{Hq} query heads over {Hkv} KV heads")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    dev, dt = q.device, q.dtype
    _build.require(name, "q", q, dev, dt)
    _build.require(name, "k", k, dev, dt, (B, T, Hkv, D))
    _build.require(name, "v", v, dev, dt, (B, T, Hkv, D))
    _build.require(name, "q_offset", q_offset, dev, torch.int32, (B,))
    _build.require(name, "kv_len", kv_len, dev, torch.int32, (B,))
    code = _build.dtype_code(dt)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        rc = _build.lib().repro_flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q_offset.data_ptr(), kv_len.data_ptr(), B, S, T, Hq, Hkv, D,
            int(window or 0), 1.0 / math.sqrt(D), code,
            _build.stream_ptr(dev))
    _build.check(rc, name)
    _build.count("flash_attention")
    return out
