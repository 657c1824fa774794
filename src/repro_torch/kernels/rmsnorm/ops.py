"""Dispatch for RMSNorm: kernel B1 (and ``add_rms_norm``, B1 with the
residual add before it fused in) on a CUDA tensor, the plain version on a
CPU tensor.  Where autograd records, the kernel's backward is the plain
version's gradient (``kernels.grad``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, grad
from repro_torch.kernels.rmsnorm.ref import add_rms_norm_ref, rms_norm_ref


def rms_norm(x, weight, eps: float = 1e-5):
    if x.device.type == "cpu":
        return rms_norm_ref(x, weight, eps)
    if grad.wanted(x, weight):
        return grad.through_plain(rms_norm_cuda, rms_norm_ref, x, weight,
                                  eps)
    return rms_norm_cuda(x, weight, eps)


def add_rms_norm(x, y, weight, eps: float = 1e-5):
    """(s, n): s = x + y, n = rms_norm(s)."""
    if x.device.type == "cpu":
        return add_rms_norm_ref(x, y, weight, eps)
    if grad.wanted(x, y, weight):
        return grad.through_plain(add_rms_norm_cuda, add_rms_norm_ref, x,
                                  y, weight, eps)
    return add_rms_norm_cuda(x, y, weight, eps)


def _check(name, x, weight):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x on {x.device}, expected a CUDA device")
    _build.require(name, "weight", weight, x.device, x.dtype,
                   (x.shape[-1],))
    return _build.dtype_code(x.dtype)


def rms_norm_cuda(x, weight, eps: float = 1e-5):
    """Launch B1 on x [..., h] (contiguous) and weight [h] of x's type."""
    name = "rms_norm_cuda"
    code = _check(name, x, weight)
    _build.require(name, "x", x, x.device, x.dtype)
    h = x.shape[-1]
    out = torch.empty_like(x)
    rows = x.numel() // h
    with torch.cuda.device(x.device):
        rc = _build.lib().repro_rmsnorm(
            x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, h,
            float(eps), code, _build.stream_ptr(x.device))
    _build.check(rc, name)
    _build.count("rmsnorm")
    return out


def _row_stride(name, what, t, h):
    """The stride between the rows of ``t`` [..., h], whose last axis must
    be contiguous and whose rows must lie at one stride (a row slice such
    as x[:, -1] of a contiguous [B, S, h] qualifies)."""
    try:
        rows = t.view(-1, h)
    except RuntimeError:
        raise ValueError(f"{name}: the rows of {what} do not lie at one "
                         f"stride (strides {t.stride()})") from None
    if h > 1 and rows.stride(1) != 1:
        raise ValueError(f"{name}: {what} needs a contiguous last axis")
    return rows.stride(0)


def add_rms_norm_cuda(x, y, weight, eps: float = 1e-5):
    """Launch B1 with the residual add fused in: x, y [..., h] of one type
    (float32 or bfloat16) and weight [h] -> (s, n), both new contiguous
    [..., h].  x and y need a contiguous last axis and rows at one stride
    each; rows or pointers off a 16-byte boundary (or h not a multiple of
    the 16-byte vector) take the kernel's element path."""
    name = "add_rms_norm_cuda"
    code = _check(name, x, weight)
    if y.device != x.device or y.dtype != x.dtype or y.shape != x.shape:
        raise ValueError(f"{name}: y is {y.dtype} {tuple(y.shape)} on "
                         f"{y.device}, x {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    h = x.shape[-1]
    xs, ys = (_row_stride(name, what, t, h) for what, t in (("x", x),
                                                             ("y", y)))
    s = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    n = torch.empty_like(s)
    with torch.cuda.device(x.device):
        rc = _build.lib().repro_add_rmsnorm(
            x.data_ptr(), xs, y.data_ptr(), ys, weight.data_ptr(),
            s.data_ptr(), n.data_ptr(), x.numel() // h, h, float(eps), code,
            _build.stream_ptr(x.device))
    _build.check(rc, name)
    _build.count("add_rms_norm")
    return s, n
