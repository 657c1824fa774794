"""Dense (GQA) transformer block of the port, shared by the dense,
encoder and vlm families.

Counterpart of ``repro.models.blocks``.  Block API, as the trunk in
``transformer.py`` calls it per layer:

    dense_block_apply(cfg, p_l, x, positions, cache=None, pos=None,
                      build_cache_w=None, block_table=None, plain=False,
                      carry=False, prefix_len=0)
        -> (y, cache_out)

``p_l`` is one layer's slice of the stacked [L, ...] parameters.  With
``carry=True`` the trunk hands the residual stream over as a pair
(h, x), the layer's input being x + h: the add that closes the previous
layer runs inside this layer's ln1 (one ``add_rms_norm`` kernel on the
card; h is None at layer 0), the attention add inside ln2, and the layer
returns ((mlp_out, s), cache_out), its own closing add left to the next
norm site (the next layer's ln1, or the final norm).  The
attention branches go through the hand-written kernels (``plain=False``):

  * full-sequence prefill            -> B2 (offset 0, kv_len = S) in the
                                        family's mask: causal, encoder
                                        bidirectional, vlm prefix over
                                        the first ``prefix_len`` keys
  * contiguous decode (ring cache)   -> B3 (lengths = min(pos + 1, W))
  * paged decode (S == 1)            -> B4 (pages read in place)
  * paged prefill chunk (S > 1)      -> paged_gather, then B2 with query
                                        offsets pos[b] and kv_len pos[b] + S
  * context-parallel prefill         -> per CP shard r of c, B2 at query
    (``cp_group``)                      offset r·S/c over the ring-assembled
                                        K/V, kv_len S

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


def _qkv(cfg: ModelConfig, p, xn, positions, Hq: int, Hkv: int):
    """RoPE'd q [B, S, Hq, D] and k, and v [B, S, Hkv, D] of xn [B, S, h]."""
    B, S, _ = xn.shape
    D = cfg.head_dim
    q = apply_rope((xn @ p["wq"]).reshape(B, S, Hq, D), positions,
                   cfg.rope_theta)
    k = apply_rope((xn @ p["wk"]).reshape(B, S, Hkv, D), positions,
                   cfg.rope_theta)
    return q, k, (xn @ p["wv"]).reshape(B, S, Hkv, D)


def paged_attention_plain(q, ck, cv, block_table, pos):
    """The plain paged branch (B4 at S == 1, or paged_gather then B2, on
    the card): the sequences' pages gathered, then GQA under the paged
    mask."""
    kg = layers.paged_gather(ck, block_table)
    vg = layers.paged_gather(cv, block_table)
    return gqa_attention(q, kg, vg,
                         layers.paged_attn_mask(kg.shape[1], pos, q.shape[1]))


def ring_attention_plain(q, ck, cv, pos, window):
    """The plain ring-cache decode branch (B3 on the card): GQA over the
    ring under its valid-slot mask."""
    return gqa_attention(q, ck, cv,
                         layers.decode_attn_mask(ck.shape[1], pos, window))


def attention_apply(cfg: ModelConfig, p, xn, positions, cache=None,
                    pos=None, build_cache_w=None, block_table=None,
                    plain: bool = False, num_heads: int = None,
                    num_kv_heads: int = None, cp_group=None,
                    prefix_len: int = 0):
    """Self-attention over a normalised input xn [B, S, h].  Returns
    (attn_out [B, S, Hq*D], cache_out); ``cache`` is updated in place.
    ``num_heads``/``num_kv_heads`` are the head counts of the weights in
    ``p`` — a TP rank's shard (Hq/t, Hkv/t) — and default to the config's.

    ``cp_group`` (a ``core.comm.VirtualGroup`` of c CP workers) selects the
    context-parallel prefill: xn and ``positions`` are then lists of the c
    sequence shards [B, S/c, h] and their absolute positions, and the
    result is (the c shards' outputs, the cache built from the assembled
    K/V or None).

    A full-sequence pass takes the family's mask (``layers.mask_mode``),
    the vlm's over a prefix of ``prefix_len`` positions; decode needs none
    (the cache's valid slots are its mask), and the paged and CP branches
    are causal, reached only by the dense family."""
    Hq = cfg.num_heads if num_heads is None else num_heads
    Hkv = cfg.num_kv_heads if num_kv_heads is None else num_kv_heads
    if cp_group is not None:
        return _cp_attention(cfg, p, xn, positions, build_cache_w, plain, Hq,
                             Hkv, cp_group)
    B, S, _ = xn.shape
    D = cfg.head_dim
    dev = xn.device
    q, k, v = _qkv(cfg, p, xn, positions, Hq, Hkv)
    window = cfg.sliding_window

    if cache is not None and block_table is not None:
        # paged path: the chunk's K/V rows land in their pages first
        ck, cv = layers.paged_cache_update(cache["k"], cache["v"], k, v,
                                           pos, block_table)
        if plain:
            out = paged_attention_plain(q, ck, cv, block_table, pos)
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
            out = ring_attention_plain(q, ck, cv, pos, window)
        else:
            out = decode_attention(
                q[:, 0].contiguous(), ck, cv,
                layers.decode_lengths(w, pos, B, dev))[:, None]
        cache_out = {"k": ck, "v": cv}
    else:
        mode = layers.mask_mode(cfg)
        if plain:
            out = gqa_attention(q, k, v, layers.make_mask(
                S, S, mode=mode, window=window, prefix_len=prefix_len,
                device=dev))
        else:
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), _i32(0, B, dev),
                                  _i32(S, B, dev), window, mode, prefix_len)
        cache_out = None
        if build_cache_w is not None:
            cache_out = build_ring_cache(k, v, build_cache_w)
    return out.reshape(B, S, Hq * D), cache_out


def _cp_attention(cfg: ModelConfig, p, xns, positions, build_cache_w,
                  plain: bool, Hq: int, Hkv: int, group):
    """The CP branch of ``attention_apply`` (prefill only): each worker's
    q/k/v of its shard at its absolute positions, K and V ring-assembled
    over ``group`` (``layers.ring_kv_assemble``), then worker r's queries
    against its assembled copy at query offset r·S/c: B2, or on the plain
    path ``gqa_attention`` on the materialised [S/c, S] mask."""
    c = len(xns)
    B, s, _ = xns[0].shape
    S, D = c * s, cfg.head_dim
    dev = xns[0].device
    window = cfg.sliding_window
    qkv = [_qkv(cfg, p, x, pos, Hq, Hkv) for x, pos in zip(xns, positions)]
    ks = layers.ring_kv_assemble([k for _, k, _ in qkv], group)
    vs = layers.ring_kv_assemble([v for _, _, v in qkv], group)
    outs = []
    for r, (q, _, _) in enumerate(qkv):
        if plain:
            out = gqa_attention(q, ks[r], vs[r], layers.make_mask(
                s, S, q_offset=r * s, window=window, device=dev))
        else:
            out = flash_attention(q.contiguous(), ks[r], vs[r],
                                  _i32(r * s, B, dev), _i32(S, B, dev),
                                  window)
        outs.append(out.reshape(B, s, Hq * D))
    cache_out = None
    if build_cache_w is not None:
        cache_out = build_ring_cache(ks[0], vs[0], build_cache_w)
    return outs, cache_out


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
                      plain: bool = False, carry: bool = False,
                      prefix_len: int = 0):
    h, x = x if carry else (None, x)
    x, xn = layers.add_norm(x, h, p["ln1"], cfg.norm_eps, plain)
    attn_out, cache_out = attention_apply(
        cfg, p, xn, positions, cache=cache, pos=pos,
        build_cache_w=build_cache_w, block_table=block_table, plain=plain,
        prefix_len=prefix_len)
    x, xn = layers.add_norm(x, attn_out @ p["wo"], p["ln2"], cfg.norm_eps,
                            plain)
    out = mlp_apply(p, xn, cfg.activation)
    return ((out, x) if carry else x + out), cache_out
