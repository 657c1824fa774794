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

    Returns (y [B,S,H,hs] in r.dtype, final state [B,H,hs,hs] f32).  On
    meta tensors (a dry run: shapes, no values) a sequence longer than
    one step does not run the loop: the outputs, and in the backward the
    inputs' gradients, are made at their shapes (``_OnMeta``)."""
    if r.device.type == "meta" and r.shape[1] > 1:
        return _OnMeta.apply(r, k, v, w, u, state)
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]       # [B,H,hs,hs]
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], s + uf * kv))
        s = wf[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s


class _OnMeta(torch.autograd.Function):
    """``wkv6_ref``'s outputs and gradients as empty meta tensors of their
    shapes and types."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.like = [(t.shape, t.dtype) for t in (r, k, v, w, u, state)]
        return (torch.empty(r.shape, dtype=r.dtype, device="meta"),
                torch.empty(state.shape, dtype=torch.float32, device="meta"))

    @staticmethod
    def backward(ctx, gy, gs):
        return tuple(torch.empty(shape, dtype=dtype, device="meta")
                     for shape, dtype in ctx.like)


def wkv6_chunk_ref(r, k, v, w, u, state, chunk: int = 16):
    """The chunked arithmetic kernel B10 runs for prefill, in plain PyTorch
    (the same function as ``wkv6_ref``).  Time is cut into chunks of
    ``chunk`` tokens, the last one ragged (any S >= 1).  Within a chunk of
    n tokens, with the decays taken as products of w (never a quotient,
    so nothing overflows and a w of exactly 0 gives exact zeros):

        y_t  = (r_t ⊙ Π_{s<t} w_s) · S_c                  inter-chunk
             + Σ_{τ<t} A[t,τ] v_τ                          intra-chunk
             + (Σ_i r_{t,i} u_i k_{t,i}) v_t                bonus (A[t,t])
        A[t,τ] = Σ_i r_{t,i} k_{τ,i} Π_{τ<s<t} w_{s,i}
        S_{c+1} = diag(Π_{s<n} w_s) S_c + Σ_τ (k_τ ⊙ Π_{s>τ} w_s) v_τᵀ

    r, k, v, w: [B,S,H,hs]; u: [H,hs]; state: [B,H,hs,hs].  Returns (y
    [B,S,H,hs] in r.dtype, final state f32)."""
    B, S, H, hs = r.shape
    uf = u.float()
    s = state.float()
    ys = []
    for c0 in range(0, S, chunk):
        rc, kc, vc, wc = (t[:, c0:c0 + chunk].float().transpose(1, 2)
                          for t in (r, k, v, w))            # [B,H,n,hs]
        n = rc.shape[2]
        ones = torch.ones_like(wc[:, :, :1])
        incl = torch.cumprod(wc, dim=2)                     # Π_{s<=t} w_s
        rd = rc * torch.cat([ones, incl[:, :, :-1]], dim=2)
        after = torch.cat([wc[:, :, 1:], ones], dim=2)      # w_{t+1}
        kd = kc * torch.cumprod(after.flip(2), dim=2).flip(2)
        # D[t,τ] = Π_{τ<s<t} w_s: w_s for s < t, 1 elsewhere, multiplied
        # from s = t-1 down to τ+1
        t_idx = torch.arange(n, device=r.device)
        below = (t_idx[None, :] < t_idx[:, None])[..., None]  # [t,s,1]
        x = torch.where(below, wc[:, :, None], 1.0)         # [B,H,t,s,hs]
        x = torch.cat([x[:, :, :, 1:], torch.ones_like(x[:, :, :, :1])], 3)
        d = torch.cumprod(x.flip(3), dim=3).flip(3)         # [B,H,t,τ,hs]
        A = torch.einsum("bhti,bhsi,bhtsi->bhts", rc, kc, d)
        A = torch.where(t_idx[None, :] < t_idx[:, None], A, 0.0)
        A = A + torch.diag_embed(torch.einsum("bhti,hi->bht", rc * kc, uf))
        y = torch.einsum("bhti,bhij->bhtj", rd, s) + A @ vc
        s = incl[:, :, -1, :, None] * s + torch.einsum("bhti,bhtj->bhij",
                                                       kd, vc)
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, dim=1).to(r.dtype), s
