"""Dispatch for RMSNorm: kernel B1 on a CUDA tensor, the plain version on
a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rms_norm_ref


def rms_norm(x, weight, eps: float = 1e-5):
    if x.device.type == "cpu":
        return rms_norm_ref(x, weight, eps)
    return rms_norm_cuda(x, weight, eps)


def rms_norm_cuda(x, weight, eps: float = 1e-5):
    """Launch B1 on x [..., h] (contiguous) and weight [h] of x's type."""
    name = "rms_norm_cuda"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x on {x.device}, expected a CUDA device")
    h = x.shape[-1]
    _build.require(name, "x", x, x.device, x.dtype)
    _build.require(name, "weight", weight, x.device, x.dtype, (h,))
    code = _build.dtype_code(x.dtype)
    out = torch.empty_like(x)
    rows = x.numel() // h
    with torch.cuda.device(x.device):
        rc = _build.lib().repro_rmsnorm(
            x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, h,
            float(eps), code, _build.stream_ptr(x.device))
    _build.check(rc, name)
    _build.count("rmsnorm")
    return out
