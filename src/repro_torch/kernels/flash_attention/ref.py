"""Plain PyTorch causal (+ window) GQA attention with per-sequence query
offsets and KV lengths: the reference B2 is held to."""
from __future__ import annotations

import math

import torch

NEG_INF = torch.finfo(torch.float32).min


def flash_attention_ref(q, k, v, q_offset, kv_len, window=None):
    """q [B,S,Hq,D]; k, v [B,T,Hkv,D]; q_offset, kv_len [B] int.

    Query s of sequence b sits at absolute position q_offset[b] + s and
    attends to KV positions t < kv_len[b] with t <= its position (and
    t > position - window).  f32 throughout, masked probabilities exactly
    0, denominator clamped at 1e-30 (a fully masked row gives 0); the
    result is cast to the type of q.
    """
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, S, Hkv, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    logits = logits * (1.0 / math.sqrt(D))
    dev = q.device
    q_pos = q_offset.to(dev, torch.int64)[:, None] + \
        torch.arange(S, device=dev)[None, :]                       # [B, S]
    kv_pos = torch.arange(T, device=dev)[None, None, :]            # [1, 1, T]
    mask = (kv_pos <= q_pos[:, :, None]) & \
        (kv_pos < kv_len.to(dev, torch.int64)[:, None, None])      # [B, S, T]
    if window is not None:
        mask &= kv_pos > q_pos[:, :, None] - window
    mask = mask[:, None, None]                                     # [B,1,1,S,T]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgst,btkd->bskgd", p / denom, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)
