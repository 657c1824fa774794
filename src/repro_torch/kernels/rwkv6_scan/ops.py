"""Dispatch for the WKV6 recurrence: kernel B10 on a CUDA tensor, the plain
version on a CPU tensor.  B10 is two hand-written kernels: the chunked,
column-tiled one for prefill and the per-step one for decode; ``wkv6_cuda``
picks by S and the number of CTAs.  Where autograd records, the backward
is the gradient of the plain form of the kernel that ran
(``kernels.grad``): ``wkv6_chunk_ref`` for the chunked kernel,
``wkv6_ref`` for the per-step one."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, grad
from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunk_ref, wkv6_ref

HEAD_SIZES = (16, 32, 64)
CHUNK = 16              # C, the chunked kernel's tokens a chunk
# The wrapper takes the chunked kernel from S = CHUNK_MIN_S on while it has
# at most CHUNK_MAX_CTAS CTAs (B·H·hs/16: two waves at two an SM), else the
# per-step one, whose (b, h) blocks fill the card by themselves.  Measured
# by chip_smoke.py's sweep at H = 64, hs = 64, bf16 on an H100: at B = 1
# the chunked kernel is faster from S = 8, at B = 2 from S = 16, at B = 4
# (1024 CTAs) at no S up to 512.
CHUNK_MIN_S = 16
CHUNK_MAX_CTAS = 512


def wkv6(r, k, v, w, u, state, state_out=None):
    """(y, final state) of the recurrence (see ``ref.wkv6_ref``).  The
    final state is written into ``state_out`` when one is given (it may be
    ``state`` itself: the decode step updates its cache in place)."""
    if r.device.type == "cpu":
        y, s = wkv6_ref(r, k, v, w, u, state)
    elif grad.wanted(r, k, v, w, u, state):
        chunk = kernel_chunk(*r.shape)
        y, s = grad.through_plain(
            functools.partial(wkv6_cuda, chunk=chunk),
            wkv6_chunk_ref if chunk else wkv6_ref, r, k, v, w, u, state)
    else:
        return wkv6_cuda(r, k, v, w, u, state, state_out)
    if state_out is None:
        return y, s
    return y, state_out.copy_(s)


def kernel_chunk(B, S, H, hs) -> int:
    """The kernel ``wkv6_cuda`` runs by default on [B, S, H, hs]: CHUNK
    (the chunked one) from S = CHUNK_MIN_S on while it has at most
    CHUNK_MAX_CTAS CTAs, else 0 (the per-step one)."""
    return CHUNK if (S >= CHUNK_MIN_S and
                     B * H * hs // 16 <= CHUNK_MAX_CTAS) else 0


def wkv6_cuda(r, k, v, w, u, state, state_out=None, chunk=None):
    """Launch B10.  r, k, v, w [B,S,H,hs] contiguous, one type (f32 or
    bf16; on 16-byte boundaries for the chunked kernel); u [H,hs] f32;
    state [B,H,hs,hs] f32; hs in HEAD_SIZES, any S >= 1.  ``state_out``
    (f32, the shape of ``state``; may be ``state``) receives the final
    state, else a new tensor does.  ``chunk`` picks the kernel: 0 the
    per-step one, CHUNK the chunked one; by default the chunked one from
    S = CHUNK_MIN_S on while it has at most CHUNK_MAX_CTAS CTAs, the
    per-step one otherwise."""
    name = "wkv6_cuda"
    if r.device.type != "cuda":
        raise ValueError(f"{name}: r on {r.device}, expected a CUDA device")
    if r.dim() != 4:
        raise ValueError(f"{name}: r must be [B,S,H,hs], got {tuple(r.shape)}")
    B, S, H, hs = r.shape
    if hs not in HEAD_SIZES or S < 1:
        raise ValueError(f"{name}: head size {hs} not in {HEAD_SIZES}, or "
                         f"S={S} < 1")
    dev, dt = r.device, r.dtype
    code = _build.dtype_code(dt)
    for what, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _build.require(name, what, t, dev, dt, (B, S, H, hs))
    _build.require(name, "u", u, dev, torch.float32, (H, hs))
    _build.require(name, "state", state, dev, torch.float32, (B, H, hs, hs))
    if state_out is None:
        state_out = torch.empty_like(state)
    _build.require(name, "state_out", state_out, dev, torch.float32,
                   (B, H, hs, hs))
    if chunk is None:
        chunk = kernel_chunk(B, S, H, hs)
    if chunk not in (0, CHUNK):
        raise ValueError(f"{name}: chunk {chunk} is neither 0 nor {CHUNK}")
    if chunk:
        for what, t in (("r", r), ("k", k), ("v", v), ("w", w)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: {what} must start on a 16-byte "
                                 f"boundary, got address {t.data_ptr()}")
    y = torch.empty_like(r)
    with torch.cuda.device(dev):
        rc = _build.lib().repro_wkv6(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(),
            state_out.data_ptr(), B, S, H, hs, chunk, code,
            _build.stream_ptr(dev))
    _build.check(rc, name)
    _build.count("wkv6")
    return y, state_out
