"""Plain PyTorch RWKV-6 (Finch) WKV recurrence: the reference B10 is held
to, and what the CPU path runs.

Per head with state S ∈ R^{hs×hs} (key channel i, value channel j):

    y_t[j]       = Σ_i r_t[i] · (S_t[i,j] + u[i]·k_t[i]·v_t[j])
    S_{t+1}[i,j] = w_t[i]·S_t[i,j] + k_t[i]·v_t[j]

with data-dependent decay w_t ∈ (0,1)^{hs} [arXiv:2404.05892, Eq. 18-19].
Counterpart of ``repro.kernels.rwkv6_scan.ref.wkv6_ref`` (its
``lax.scan`` is a Python loop over time here).
"""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u, state):
    """r, k, v, w: [B,S,H,hs]; u: [H,hs]; state: [B,H,hs,hs].

    Returns (y [B,S,H,hs] in r.dtype, final state [B,H,hs,hs] f32)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]       # [B,H,hs,hs]
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], s + uf * kv))
        s = wf[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s
