"""Plain PyTorch GQA attention with per-sequence query offsets and KV
lengths, in the causal, bidirectional or prefix mask and an optional
window: the reference B2 is held to."""
from __future__ import annotations

import math

import torch

NEG_INF = torch.finfo(torch.float32).min
MASK_MODES = ("causal", "bidirectional", "prefix")


def visible_prefix(mode: str, prefix_len: int, kv_len: int) -> int:
    """The number of leading keys every query sees: 0 (causal), the
    prefix's length (prefix), or every key (bidirectional).  With it the
    three masks of ``layers.make_mask`` are one: key t is visible to the
    query at position p when t <= p or t < this count."""
    if mode == "causal":
        return 0
    if mode == "prefix":
        if prefix_len < 0:
            raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
        return int(prefix_len)
    if mode == "bidirectional":
        return int(kv_len)
    raise ValueError(f"mask mode {mode!r} not in {MASK_MODES}")


def flash_attention_ref(q, k, v, q_offset, kv_len, window=None,
                        p_dtype=None, mode: str = "causal",
                        prefix_len: int = 0):
    """q [B,S,Hq,D]; k, v [B,T,Hkv,D]; q_offset, kv_len [B] int.

    Query s of sequence b sits at absolute position q_offset[b] + s and
    attends to KV positions t < kv_len[b] that the mask ``mode`` lets it
    see — t <= its position (causal), every t (bidirectional), or t <= its
    position or t < ``prefix_len`` (prefix) — and, with a window, t >
    position - window in every mode (``layers.make_mask``).  f32
    throughout, masked probabilities exactly 0, denominator clamped at
    1e-30 (a fully masked row gives 0); the result is cast to the type of
    q.

    ``p_dtype`` (a model of B2's bf16 tensor-core numerics, for the tests):
    the unnormalised probabilities are rounded to it before the P·V
    product and the f32 sum divides afterwards.  None (the plain version
    every kernel is held to) keeps P in f32.
    """
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    prefix = visible_prefix(mode, prefix_len, T)
    qg = q.float().reshape(B, S, Hkv, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    logits = logits * (1.0 / math.sqrt(D))
    dev = q.device
    q_pos = q_offset.to(dev, torch.int64)[:, None] + \
        torch.arange(S, device=dev)[None, :]                       # [B, S]
    kv_pos = torch.arange(T, device=dev)[None, None, :]            # [1, 1, T]
    mask = ((kv_pos <= q_pos[:, :, None]) | (kv_pos < prefix)) & \
        (kv_pos < kv_len.to(dev, torch.int64)[:, None, None])      # [B, S, T]
    if window is not None:
        mask &= kv_pos > q_pos[:, :, None] - window
    mask = mask[:, None, None]                                     # [B,1,1,S,T]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if p_dtype is None:
        out = torch.einsum("bkgst,btkd->bskgd", p / denom, v.float())
    else:
        out = torch.einsum("bkgst,btkd->bskgd", p.to(p_dtype).float(),
                           v.float()) / denom.permute(0, 3, 1, 2, 4)
    return out.reshape(B, S, Hq, D).to(q.dtype)
