"""Shared layers of the dense-block families (dense, encoder, vlm): init,
RMSNorm, RoPE, masks, KV-cache updates, the plain GQA attention and the
SwiGLU/GeGLU/GELU MLP.

Counterpart of ``repro.models.layers`` (dense subset).  ``rms_norm`` goes
through kernel B1 on a CUDA tensor, ``add_norm`` (a norm site of the
trunk, with the residual add before it) through ``add_rms_norm``;
``gqa_attention`` and the mask builders are the plain path the attention
kernels are held to on the whole model.
The cache updates write in place (the JAX package donated the buffer and
rebuilt it functionally).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.flash_attention.ref import visible_prefix
from repro_torch.kernels.rmsnorm.ops import add_rms_norm, rms_norm  # (B1)
from repro_torch.kernels.rmsnorm.ref import add_rms_norm_ref, rms_norm_ref

NEG_INF = torch.finfo(torch.float32).min

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, scale=None):
    """normal * scale (default 1/sqrt(fan_in)), drawn in f32 from ``gen``
    on the generator's device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def add_norm(x, y, weight, eps: float, plain: bool = False):
    """A norm site of the trunk: (s, n) with s = x + y, the residual stream
    once the add that closes the branch y is done (s = x when y is None),
    and n = rms_norm(s).  On the card one kernel runs both
    (``add_rms_norm``; B1 alone when y is None); ``plain=True`` runs the
    plain versions, which are the unfused chain."""
    if y is None:
        x = x.contiguous()
        return x, (rms_norm_ref if plain else rms_norm)(x, weight, eps)
    return (add_rms_norm_ref if plain else add_rms_norm)(x, y, weight, eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def apply_rope(x, positions, theta: float):
    """x [..., S, H, D]; positions [..., S] int.  Half-split (not
    interleaved) rotation: the first and second halves of D pair up.
    Angles in f32 from theta^(-i/half)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., :, None, None].to(torch.float32) * freq
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# masks (the plain path)
# ---------------------------------------------------------------------------


# the attention mask each family's full-sequence pass takes (the JAX
# trunk's ``_mask``): the encoder sees the whole clip, the vlm its image
# prefix from every position and the text causally
_MASK_MODES = {"encoder": "bidirectional", "vlm": "prefix"}


def mask_mode(cfg: ModelConfig) -> str:
    return _MASK_MODES.get(cfg.family, "causal")


def make_mask(q_len: int, kv_len: int, *, mode: str = "causal",
              q_offset: int = 0, window=None, prefix_len: int = 0,
              device=None):
    """Boolean [q_len, kv_len] mask (True = attend); query i sits at
    position q_offset + i (a CP shard's rows of the sequence).  ``mode``:
    "causal", "bidirectional", or "prefix" (the first ``prefix_len`` keys
    visible to every query, the rest causal, PaliGemma-style); ``window``
    ANDs a sliding window on top in every mode."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    mask = (kv_pos <= q_pos) | (kv_pos < visible_prefix(mode, prefix_len,
                                                        kv_len))
    if window is not None:
        mask &= kv_pos > q_pos - window
    return mask


def decode_cache_mask(cache_len: int, pos, window=None):
    """Valid-slot mask of a (ring-buffer) KV cache: [cache_len] for a scalar
    ``pos``, [B, cache_len] for a [B] tensor.  With a window every slot is
    valid once pos > cache_len."""
    pos = torch.as_tensor(pos)
    idx = torch.arange(cache_len, device=pos.device)
    p = pos[..., None]
    mask = idx < p
    if window is not None:
        mask = mask | (p > cache_len)
    return mask


def decode_positions(pos, batch: int, device=None):
    """RoPE positions [B, 1] for one decode step from a scalar or [B] pos."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=device)
    if pos.dim() == 0:
        return pos.expand(batch)[:, None]
    return pos[:, None]


def decode_attn_mask(cache_len: int, pos, window=None):
    """`gqa_attention` mask for one decode step: [1, W] for a scalar
    position, [B, 1, 1, 1, W] for pos [B]."""
    pos = torch.as_tensor(pos)
    m = decode_cache_mask(cache_len, pos + 1, window)
    if pos.dim() == 0:
        return m[None, :]
    return m[:, None, None, None, :]


def decode_lengths(cache_len: int, pos, batch: int, device=None):
    """Per-sequence valid-slot counts of the ring cache for one decode step
    at ``pos`` (scalar or [B]): decode_cache_mask(W, pos + 1, window) is
    exactly ``idx < min(pos + 1, W)`` (every slot once the ring wraps), the
    form kernel B3 takes.  int32 [B]."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=device)
    lengths = torch.clamp(pos + 1, max=cache_len).to(torch.int32)
    return lengths.expand(batch).contiguous() if lengths.dim() == 0 \
        else lengths


def paged_attn_mask(kv_len: int, pos, q_len: int):
    """[B, 1, 1, S, T] causal mask of a paged chunk step: query s of
    sequence b sits at position pos[b] + s."""
    q_pos = pos[:, None] + torch.arange(q_len, device=pos.device)[None, :]
    kv_pos = torch.arange(kv_len, device=pos.device)
    m = kv_pos[None, None, :] <= q_pos[:, :, None]
    return m[:, None, None, :, :]


# ---------------------------------------------------------------------------
# the context-parallel ring
# ---------------------------------------------------------------------------


def ring_kv_assemble(blocks, group):
    """Ring all-gather of the c CP workers' K or V blocks, assembled in
    absolute sequence order.

    ``blocks[r]`` [B, S/c, Hkv, D] is worker r's block, the rows
    [r·S/c, (r+1)·S/c) of the sequence.  Each worker writes its own block
    at its rows, then c - 1 ``collective_permute`` rounds over ``group``
    (c workers) each forward the block a worker received last round to its
    ring successor, which receives it straight into its own buffer at the
    block's absolute rows (a device copy).  Returns the c workers'
    assembled [B, S, Hkv, D] tensors, each bitwise the blocks concatenated
    in order.  Two calls a layer (K and V) give the 2·(c-1) ring rows per
    layer of ``commodel.cp_comm_ops``; each is logged as one worker's
    [B, S/c, Hkv·D] block.
    """
    c = len(blocks)
    B, s, H, D = blocks[0].shape
    full = [b.new_empty((B, c * s, H * D)) for b in blocks]

    def rows(w, src):
        return full[w][:, src * s:(src + 1) * s]

    cur = []
    for w, b in enumerate(blocks):
        cur.append(rows(w, w))
        cur[w].copy_(b.reshape(B, s, H * D))
    for step in range(1, c):
        # worker w receives the block that started on worker w - step
        cur = group.collective_permute(
            cur, [rows(w, (w - step) % c) for w in range(c)])
    return [f.view(B, c * s, H, D) for f in full]


# ---------------------------------------------------------------------------
# KV caches (updated in place)
# ---------------------------------------------------------------------------


def ring_cache_update(cache_k, cache_v, k, v, pos):
    """Write this step's K/V row into slot ``pos % W`` of a ring cache, in
    place.  cache_k/v [B, W, Hkv, D]; k/v [B, 1, Hkv, D]; pos scalar (every
    sequence at one slot) or [B] (each at its own)."""
    w = cache_k.shape[1]
    slot = torch.as_tensor(pos, device=cache_k.device).long() % w
    if slot.dim() == 0:
        cache_k.index_copy_(1, slot.reshape(1), k)
        cache_v.index_copy_(1, slot.reshape(1), v)
        return cache_k, cache_v
    bidx = torch.arange(cache_k.shape[0], device=cache_k.device)
    cache_k[bidx, slot] = k[:, 0]
    cache_v[bidx, slot] = v[:, 0]
    return cache_k, cache_v


def _paged_rows(ps, k, pos, block_table):
    S = k.shape[1]
    lp = pos.long()[:, None] + torch.arange(S, device=k.device)[None, :]
    phys = torch.gather(block_table.long(), 1, lp // ps)
    return (phys * ps + lp % ps).reshape(-1)                  # [B*S]


def paged_cache_update(cache_k, cache_v, k, v, pos, block_table):
    """Write a chunk's K/V rows into their block-table pages, in place.

    cache_k/v [P, ps, Hkv, D]; k/v [B, S, Hkv, D]; pos [B] start positions;
    block_table [B, n].  Logical position q of sequence b goes to physical
    row block_table[b, q // ps] * ps + q % ps.  Live pages belong to one
    sequence each (runtime/kvpool.py), so destinations are distinct except
    scratch page 0, which inactive slots alias on purpose: their rows are
    garbage and ``index_copy_`` keeps one of the duplicates there.
    """
    P, ps, Hkv, D = cache_k.shape
    rows = _paged_rows(ps, k, pos, block_table)
    cache_k.view(P * ps, Hkv, D).index_copy_(0, rows, k.reshape(-1, Hkv, D))
    cache_v.view(P * ps, Hkv, D).index_copy_(0, rows, v.reshape(-1, Hkv, D))
    return cache_k, cache_v


def paged_gather(pages, block_table):
    """Logical KV view of a block table: pages [P, ps, Hkv, D] + table
    [B, n] -> [B, n*ps, Hkv, D] (rows past a sequence's length alias
    whatever page the table names and must be masked)."""
    B, n = block_table.shape
    out = pages[block_table.long()]                         # [B, n, ps, Hkv, D]
    return out.reshape(B, n * pages.shape[1], *pages.shape[2:])


# ---------------------------------------------------------------------------
# attention: the plain path (the kernels live in repro_torch.kernels)
# ---------------------------------------------------------------------------


def gqa_attention(q, k, v, mask):
    """Grouped-query attention as the JAX package computes it.

    q [B, S, Hq, D]; k, v [B, T, Hkv, D]; mask broadcastable to
    [B, Hkv, G, S, T].  Logits in the input type then f32, probabilities
    cast back to the input type before the PV product.  Returns
    [B, S, Hq, D].
    """
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    logits = logits * (1.0 / math.sqrt(D))
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, Hq, D)


def init_attention(gen, cfg: ModelConfig, num_layers: int, dtype,
                   n_heads: int = None):
    """wq/wk/wv/wo of ``n_heads`` query heads (default the config's; the
    hybrid family's attention half has fewer)."""
    n_heads = n_heads or cfg.num_heads
    h, d, L = cfg.d_model, cfg.head_dim, num_layers
    return {
        "wq": dense_init(gen, (L, h, n_heads * d), dtype),
        "wk": dense_init(gen, (L, h, cfg.num_kv_heads * d), dtype),
        "wv": dense_init(gen, (L, h, cfg.num_kv_heads * d), dtype),
        "wo": dense_init(gen, (L, n_heads * d, h), dtype),
    }


# ---------------------------------------------------------------------------
# GLU / MLP
# ---------------------------------------------------------------------------


def init_mlp(gen, d_model: int, d_ff: int, activation: str,
             num_layers: int, dtype) -> dict:
    L = num_layers
    p = {"w1": dense_init(gen, (L, d_model, d_ff), dtype),
         "w2": dense_init(gen, (L, d_ff, d_model), dtype)}
    if activation in ("swiglu", "geglu"):
        p["w3"] = dense_init(gen, (L, d_model, d_ff), dtype)
    return p


def mlp_apply(p, x, activation: str):
    up = x @ p["w1"]
    if activation == "swiglu":
        act = F.silu(up) * (x @ p["w3"])
    elif activation == "geglu":
        act = F.gelu(up, approximate="tanh") * (x @ p["w3"])
    else:
        act = F.gelu(up, approximate="tanh")
    return act @ p["w2"]
