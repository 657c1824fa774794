"""Plain PyTorch RMSNorm, and the residual add fused before it: the
references B1 and ``add_rms_norm`` are held to."""
from __future__ import annotations

import torch


def rms_norm_ref(x, weight, eps: float = 1e-5):
    """x * rsqrt(mean(x^2) + eps) * (1 + w) over the last axis, in f32,
    cast back to the type of x."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def add_rms_norm_ref(x, y, weight, eps: float = 1e-5):
    """The residual add and the norm after it: (s, n) with s = x + y (the
    new residual stream, rounded to the type of x) and n = rms_norm_ref(s)."""
    s = x + y
    return s, rms_norm_ref(s, weight, eps)
