"""Dense (GQA) transformer block of the port.

Counterpart of ``repro.models.blocks`` (dense family).  Block API, as the
trunk in ``transformer.py`` calls it per layer:

    dense_block_apply(cfg, p_l, x, positions, cache=None, pos=None,
                      build_cache_w=None, block_table=None, plain=False,
                      carry=False)
        -> (y, cache_out)

``p_l`` is one layer's slice of the stacked [L, ...] parameters.  With
``carry=True`` the trunk hands the residual stream over as a pair
(h, x), the layer's input being x + h: the add that closes the previous
layer runs inside this layer's ln1 (one ``add_rms_norm`` kernel on the
card; h is None at layer 0), the attention add inside ln2, and the layer
returns ((mlp_out, s), cache_out), its own closing add left to the next
norm site (the next layer's ln1, or the final norm).  The
attention branches go through the hand-written kernels (``plain=False``):

  * full-sequence prefill            -> B2 (offset 0, kv_len = S)
  * contiguous decode (ring cache)   -> B3 (lengths = min(pos + 1, W))
  * paged decode (S == 1)            -> B4 (pages read in place)
  * paged prefill chunk (S > 1)      -> paged_gather, then B2 with query
                                        offsets pos[b] and kv_len pos[b] + S

``plain=True`` runs the JAX package's own path instead — the materialised
masks and ``layers.gqa_attention``, and the plain RMSNorm and residual
adds — which is what the kernel path is held to on the whole model.
"""
from __future__ import annotations

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      paged_decode_attention)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers
from repro_torch.models.layers import apply_rope, gqa_attention, mlp_apply


def build_ring_cache(k, v, w: int):
    """Ring-buffer cache of width W seeded from full-sequence K/V
    [B, S, Hkv, D]: absolute position p lives in slot p % W (identity
    layout, right-padded, for S <= W; the last W positions otherwise)."""
    B, S, Hkv, D = k.shape
    ck = k.new_zeros((B, w, Hkv, D))
    cv = v.new_zeros((B, w, Hkv, D))
    if S <= w:
        ck[:, :S] = k
        cv[:, :S] = v
    else:
        slots = torch.arange(S - w, S, device=k.device) % w
        ck[:, slots] = k[:, S - w:]
        cv[:, slots] = v[:, S - w:]
    return {"k": ck, "v": cv}


def _i32(x, batch, device):
    x = torch.as_tensor(x, dtype=torch.int32, device=device)
    return x.expand(batch).contiguous() if x.dim() == 0 else x.contiguous()


def attention_apply(cfg: ModelConfig, p, xn, positions, cache=None,
                    pos=None, build_cache_w=None, block_table=None,
                    plain: bool = False, num_heads: int = None,
                    num_kv_heads: int = None):
    """Self-attention over a normalised input xn [B, S, h].  Returns
    (attn_out [B, S, Hq*D], cache_out); ``cache`` is updated in place.
    ``num_heads``/``num_kv_heads`` are the head counts of the weights in
    ``p`` — a TP rank's shard (Hq/t, Hkv/t) — and default to the config's."""
    B, S, _ = xn.shape
    Hq = cfg.num_heads if num_heads is None else num_heads
    Hkv = cfg.num_kv_heads if num_kv_heads is None else num_kv_heads
    D = cfg.head_dim
    dev = xn.device
    q = (xn @ p["wq"]).reshape(B, S, Hq, D)
    k = (xn @ p["wk"]).reshape(B, S, Hkv, D)
    v = (xn @ p["wv"]).reshape(B, S, Hkv, D)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window

    if cache is not None and block_table is not None:
        # paged path: the chunk's K/V rows land in their pages first
        ck, cv = layers.paged_cache_update(cache["k"], cache["v"], k, v,
                                           pos, block_table)
        if plain:
            kg = layers.paged_gather(ck, block_table)
            vg = layers.paged_gather(cv, block_table)
            out = gqa_attention(q, kg, vg,
                                layers.paged_attn_mask(kg.shape[1], pos, S))
        elif S == 1:
            out = paged_decode_attention(
                q[:, 0].contiguous(), ck, cv, _i32(block_table, B, dev),
                _i32(pos + 1, B, dev))[:, None]
        else:
            kg = layers.paged_gather(ck, block_table)
            vg = layers.paged_gather(cv, block_table)
            out = flash_attention(q.contiguous(), kg, vg, _i32(pos, B, dev),
                                  _i32(pos + S, B, dev))
        cache_out = {"k": ck, "v": cv}
    elif cache is not None:
        # one decode token against the ring cache; pos scalar or [B]
        w = cache["k"].shape[1]
        ck, cv = layers.ring_cache_update(cache["k"], cache["v"], k, v, pos)
        if plain:
            out = gqa_attention(q, ck, cv,
                                layers.decode_attn_mask(w, pos, window))
        else:
            out = decode_attention(
                q[:, 0].contiguous(), ck, cv,
                layers.decode_lengths(w, pos, B, dev))[:, None]
        cache_out = {"k": ck, "v": cv}
    else:
        if plain:
            out = gqa_attention(q, k, v, layers.make_mask(
                S, S, window=window, device=dev))
        else:
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), _i32(0, B, dev),
                                  _i32(S, B, dev), window)
        cache_out = None
        if build_cache_w is not None:
            cache_out = build_ring_cache(k, v, build_cache_w)
    return out.reshape(B, S, Hq * D), cache_out


def init_dense_blocks(gen, cfg: ModelConfig, L: int, dtype):
    p = layers.init_attention(gen, cfg, L, dtype)
    p.update(layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, L,
                             dtype))
    for name in ("ln1", "ln2"):
        p[name] = torch.zeros((L, cfg.d_model), dtype=dtype,
                              device=gen.device)
    return p


def dense_block_apply(cfg: ModelConfig, p, x, positions, cache=None,
                      pos=None, build_cache_w=None, block_table=None,
                      plain: bool = False, carry: bool = False):
    h, x = x if carry else (None, x)
    x, xn = layers.add_norm(x, h, p["ln1"], cfg.norm_eps, plain)
    attn_out, cache_out = attention_apply(
        cfg, p, xn, positions, cache=cache, pos=pos,
        build_cache_w=build_cache_w, block_table=block_table, plain=plain)
    x, xn = layers.add_norm(x, attn_out @ p["wo"], p["ln2"], cfg.norm_eps,
                            plain)
    out = mlp_apply(p, xn, cfg.activation)
    return ((out, x) if carry else x + out), cache_out
