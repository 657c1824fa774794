"""Chunk-parallel WKV6: matmul-form linear attention in sub-chunks.

Counterpart of ``repro.kernels.rwkv6_scan.chunked.wkv6_chunked`` (plain
jnp there, plain PyTorch here; not a kernel).  Time is processed in
chunks of C tokens:

  intra-chunk:  y_t += Σ_{τ<t} (r_t ⊙ e^{Λ_{t-1}-Λ_τ}) · k_τ · v_τ
                via an exact pairwise [C, C, hs] log-domain decay tensor
  diagonal:     y_t += (r_t ⊙ u ⊙ k_t) · v_t
  inter-chunk:  y_t += (r_t ⊙ e^{Λ_{t-1}}) · S_chunk_start
  state update: S' = diag(e^{Λ_C}) S + Σ_τ (k_τ ⊙ e^{Λ_C-Λ_τ}) v_τᵀ

with Λ the running per-channel log-decay cumsum; every exponent is <= 0,
so everything is stable in f32.  The model takes this path only when
``cfg.ssm.scan_impl == "chunked"`` and the chunk divides the sequence.
"""
from __future__ import annotations

import torch


def wkv6_chunked(r, k, v, w, u, state, *, chunk: int = 16):
    """r, k, v, w: [B,S,H,hs]; u: [H,hs]; state: [B,H,hs,hs].

    Returns (y [B,S,H,hs] in r.dtype, final state f32).  Requires
    S % min(chunk, S) == 0."""
    B, S, H, hs = r.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} not divisible by chunk={chunk}")
    n = S // chunk

    def to_chunks(t):   # [B,S,H,hs] -> [n,B,H,C,hs]
        return t.reshape(B, n, chunk, H, hs).permute(1, 0, 3, 2, 4).float()

    rc, kc, vc, wc = map(to_chunks, (r, k, v, w))
    uf = u.float()
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    s = state.float()
    ys = []
    for c in range(n):
        r_c, k_c, v_c, w_c = rc[c], kc[c], vc[c], wc[c]     # [B,H,C,hs]
        lw = torch.log(torch.clamp(w_c, min=1e-38))
        lam = torch.cumsum(lw, dim=2)                       # Λ_τ (inclusive)
        lam_ex = lam - lw                                   # Λ_{t-1}
        lam_end = lam[:, :, -1:, :]                         # Λ_C
        expo = lam_ex[:, :, :, None, :] - lam[:, :, None, :, :]
        d = torch.where(causal[None, None, :, :, None], expo, -torch.inf)
        A = torch.einsum("bhti,bhsi,bhtsi->bhts", r_c, k_c, torch.exp(d))
        diag = torch.einsum("bhti,hi->bht", r_c * k_c, uf)
        y = torch.einsum("bhts,bhsj->bhtj", A, v_c)
        y = y + diag[..., None] * v_c
        y = y + torch.einsum("bhti,bhij->bhtj", r_c * torch.exp(lam_ex), s)
        k_hat = k_c * torch.exp(lam_end - lam)
        s = torch.exp(lam_end[:, :, 0, :])[..., None] * s \
            + torch.einsum("bhsi,bhsj->bhij", k_hat, v_c)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, S, H, hs)
    return y.to(r.dtype), s
