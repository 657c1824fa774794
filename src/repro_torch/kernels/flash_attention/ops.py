"""Dispatch for prefill attention: kernel B2 on a CUDA tensor, the plain
version on a CPU tensor.  Where autograd records, B2's backward is the
plain version's gradient (``kernels.grad``): it materialises the
[B, Hq, S, T] f32 scores of one call."""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build, grad
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     visible_prefix)

HEAD_DIMS = (32, 64, 80, 128, 256)


def flash_attention(q, k, v, q_offset, kv_len, window=None,
                    mode="causal", prefix_len=0):
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_offset, kv_len, window,
                                   mode=mode, prefix_len=prefix_len)
    if grad.wanted(q, k, v):
        kw = dict(window=window, mode=mode, prefix_len=prefix_len)
        return grad.through_plain(
            functools.partial(flash_attention_cuda, **kw),
            functools.partial(flash_attention_ref, **kw),
            q, k, v, q_offset, kv_len)
    return flash_attention_cuda(q, k, v, q_offset, kv_len, window, mode,
                                prefix_len)


def flash_attention_cuda(q, k, v, q_offset, kv_len, window=None,
                         mode="causal", prefix_len=0):
    """Launch B2: the tensor-core kernel for bf16, the CUDA-core kernel
    for f32.  q [B,S,Hq,D]; k, v [B,T,Hkv,D]; q_offset, kv_len [B] int32 —
    all contiguous on one CUDA device, q, k and v on 16-byte boundaries
    (the bf16 kernel copies 16 bytes a thread).  ``mode`` is the mask
    ("causal", "bidirectional" or "prefix" over the first ``prefix_len``
    keys), the window ANDed on top (``flash_attention_ref``)."""
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
    prefix = visible_prefix(mode, prefix_len, T)
    dev, dt = q.device, q.dtype
    _build.require(name, "q", q, dev, dt)
    _build.require(name, "k", k, dev, dt, (B, T, Hkv, D))
    _build.require(name, "v", v, dev, dt, (B, T, Hkv, D))
    _build.require(name, "q_offset", q_offset, dev, torch.int32, (B,))
    _build.require(name, "kv_len", kv_len, dev, torch.int32, (B,))
    code = _build.dtype_code(dt)
    for what, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must start on a 16-byte "
                             f"boundary, got address {t.data_ptr()}")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        rc = _build.lib().repro_flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q_offset.data_ptr(), kv_len.data_ptr(), B, S, T, Hq, Hkv, D,
            int(window or 0), prefix, 1.0 / math.sqrt(D), code,
            _build.stream_ptr(dev))
    _build.check(rc, name)
    _build.count("flash_attention")
    return out
