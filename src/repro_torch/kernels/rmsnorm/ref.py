"""Plain PyTorch RMSNorm: the reference B1 is held to."""
from __future__ import annotations

import torch


def rms_norm_ref(x, weight, eps: float = 1e-5):
    """x * rsqrt(mean(x^2) + eps) * (1 + w) over the last axis, in f32,
    cast back to the type of x."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)
