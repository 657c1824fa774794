"""Dense (GQA) transformer block of the port, shared by the dense,
encoder and vlm families; its attention (and, on a sharded step, its
attention and MLP sites) also serve the moe and hybrid blocks.

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
masks and ``layers.gqa_attention`` (``layers.chunked_gqa_attention`` where
``cfg.attention_impl`` is "chunked"), and the plain RMSNorm and residual
adds — which is what the kernel path is held to on the whole model.

Under a ``DeviceMesh`` (``runtime.meshctx``) the block runs sharded
(``_dense_block_sharded``): the attention with its out-projection and
the MLP are sites on the local shards (``sharding.local_site``), each
leaving a partial sum over "model" for the next norm site to all-reduce,
the branches above dispatching inside as on one device.  The attention
site takes the attention's query head count (hymba's n_attn of its
heads), and ``close_sharded`` ends a layer of any family.
"""
from __future__ import annotations


import torch

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import (
    SPLIT_KEYS, decode_attention, decode_attention_partials,
    paged_decode_attention)
from repro_torch.kernels.decode_attention.ref import split_partials
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers
from repro_torch.models.layers import apply_rope, gqa_attention, mlp_apply
from repro_torch.runtime import meshctx
from repro_torch.runtime import sharding as sh


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


def _qkv(cfg: ModelConfig, p, xn, positions, Hq: int, Hkv: int,
         copy=None, post=None):
    """RoPE'd q [B, S, Hq, D] and k, and v [B, S, Hkv, D] of xn [B, S, h].
    ``copy`` wraps xn before each projection (``sharding.copy_to_model``
    on a sharded step's local shards); ``post`` maps a projection's name
    ("wq", "wk", "wv") to a function of its output, applied before the
    heads are split (a sharded step's all-gather of column-parallel
    shards over "model")."""
    B, S, _ = xn.shape
    D = cfg.head_dim
    f = copy or (lambda t: t)
    post = post or {}

    def proj(name, heads):
        t = f(xn) @ p[name]
        if name in post:
            t = post[name](t)
        return t.reshape(B, S, heads, D)

    q = apply_rope(proj("wq", Hq), positions, cfg.rope_theta)
    k = apply_rope(proj("wk", Hkv), positions, cfg.rope_theta)
    return q, k, proj("wv", Hkv)


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

    ``cp_group`` (the CP group of c workers: a ``core.comm.VirtualGroup``,
    or a ``DistGroup`` whose process holds one of them) selects the
    context-parallel prefill: xn and ``positions`` are then lists of the
    local workers' sequence shards [B, S/c, h] and their absolute
    positions, and the result is (their outputs, the cache built from the
    assembled K/V or None).

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
    else:
        out, cache_out = _attend(cfg, q, k, v, cache, pos, build_cache_w,
                                 plain, prefix_len)
    return out.reshape(B, S, Hq * D), cache_out


def _attend(cfg: ModelConfig, q, k, v, cache, pos, build_cache_w,
            plain: bool, prefix_len: int):
    """The ring-cache decode branch (``cache`` given: B3, or the plain
    version) and the full-sequence branch (B2, or the plain version:
    ``gqa_attention`` on the materialised mask, or
    ``layers.chunked_gqa_attention`` where ``cfg.attention_impl`` is
    "chunked") of ``attention_apply`` on q [B, S, Hq, D] and k, v
    [B, S, Hkv, D] -> (out [B, S, Hq, D], cache_out)."""
    B, S = q.shape[:2]
    dev = q.device
    window = cfg.sliding_window
    if cache is not None:
        # one decode token against the ring cache; pos scalar or [B]
        w = cache["k"].shape[1]
        ck, cv = layers.ring_cache_update(cache["k"], cache["v"], k, v, pos)
        if plain:
            out = ring_attention_plain(q, ck, cv, pos, window)
        else:
            out = decode_attention(
                q[:, 0].contiguous(), ck, cv,
                layers.decode_lengths(w, pos, B, dev))[:, None]
        return out, {"k": ck, "v": cv}
    mode = layers.mask_mode(cfg)
    if plain and cfg.attention_impl == "chunked":
        out = layers.chunked_gqa_attention(
            q, k, v, mode=mode, window=window, prefix_len=prefix_len,
            kv_chunk=cfg.attention_chunk)
    elif plain:
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
    return out, cache_out


def _cp_attention(cfg: ModelConfig, p, xns, positions, build_cache_w,
                  plain: bool, Hq: int, Hkv: int, group):
    """The CP branch of ``attention_apply`` (prefill only) over the CP
    ``group`` of c workers: each local worker's q/k/v of its shard at its
    absolute positions (``xns`` and ``positions`` hold one entry per
    ``group.local_ranks``), K and V ring-assembled over ``group``
    (``layers.ring_kv_assemble``), then worker r's queries against its
    assembled copy at query offset r·S/c: B2, or on the plain path
    ``gqa_attention`` on the materialised [S/c, S] mask.  The cache is
    built from the assembled K/V, whole on every worker."""
    c = group.t
    B, s, _ = xns[0].shape
    S, D = c * s, cfg.head_dim
    dev = xns[0].device
    window = cfg.sliding_window
    qkv = [_qkv(cfg, p, x, pos, Hq, Hkv) for x, pos in zip(xns, positions)]
    ks = layers.ring_kv_assemble([k for _, k, _ in qkv], group)
    vs = layers.ring_kv_assemble([v for _, _, v in qkv], group)
    outs = []
    for i, (r, (q, _, _)) in enumerate(zip(group.local_ranks, qkv)):
        if plain:
            out = gqa_attention(q, ks[i], vs[i], layers.make_mask(
                s, S, q_offset=r * s, window=window, device=dev))
        else:
            out = flash_attention(q.contiguous(), ks[i], vs[i],
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
    if meshctx.get_device_mesh() is not None:
        return _dense_block_sharded(cfg, p, x, positions, cache, pos,
                                    build_cache_w, block_table, plain,
                                    carry, prefix_len)
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


# ---------------------------------------------------------------------------
# the sharded step (a DeviceMesh in ``runtime.meshctx``)
# ---------------------------------------------------------------------------


def kv_layout(cfg: ModelConfig, m: int, width) -> str:
    """Where a layer's K/V lie over a model axis of m devices
    (``sharding.cache_specs``' rule): "heads" when the KV heads divide m,
    else "seq" (the cache's rows split over "model": sequence-parallel
    decode) when the cache width does, else "replicated"; a pass with no
    cache is "heads" or "gather"."""
    if cfg.num_kv_heads % m == 0:
        return "heads"
    if width is None:
        return "gather"
    return "seq" if width % m == 0 else "replicated"


def _dense_block_sharded(cfg, p, x, positions, cache, pos, build_cache_w,
                         block_table, plain, carry, prefix_len):
    """``dense_block_apply`` on DTensors: the norms at the two
    redistribution points (``layers.add_norm``), the attention and the MLP
    each one site on the local shards whose row-parallel output leaves it
    as a partial sum over "model"."""
    if block_table is not None:
        raise NotImplementedError("paged serving is not sharded")
    h, x = x if carry else (None, x)
    x, xn = layers.add_norm(x, h, p["ln1"], cfg.norm_eps, plain)
    y, cache_out = _attention_sharded(cfg, p, xn, positions, cache, pos,
                                      build_cache_w, plain, prefix_len)
    x, xn = layers.add_norm(x, y, p["ln2"], cfg.norm_eps, plain)
    out = _mlp_sharded(p, xn, cfg.activation)
    return close_sharded(x, out, carry), cache_out


def close_sharded(x, out, carry: bool):
    """A sharded layer's end: the carried pair (out, x), or x + out, out
    all-reduced over "model" first where it is a partial sum."""
    if carry:
        return out, x
    if sh.is_partial_model(out):
        return sh.local_site(lambda x, o: x + sh.reduce_model(o),
                             x.placements, x, out)
    return sh.local_site(lambda x, o: x + o, x.placements, x, out)


def _mlp_sharded(p, xn, activation: str):
    """The MLP on the local shards: column-parallel w1 (and w3), each
    input through ``copy_to_model``, row-parallel w2; the output is a
    partial sum over "model"."""
    glu = activation in ("swiglu", "geglu")
    names = ("w1", "w2", "w3") if glu else ("w1", "w2")
    if not all(sh.model_sharded(p[n]) for n in names):
        raise NotImplementedError("a sharded MLP needs d_ff to divide the "
                                  "model axis")

    def local(xn, *ws):
        return mlp_apply(dict(zip(names, ws)), xn, activation,
                         copy=sh.copy_to_model)

    return sh.local_site(local, sh.partial_model(xn.placements), xn,
                         *(p[n] for n in names),
                         weights=tuple(range(1, len(names) + 1)))


def _attention_sharded(cfg, p, xn, positions, cache, pos, build_cache_w,
                       plain, prefix_len, num_heads=None):
    """The attention site of a sharded step, the out-projection included
    -> (y [B, S, h], a partial sum over "model"; the cache).
    ``num_heads`` is the attention's query head count (the config's by
    default; hymba's ``n_attn``).  By ``kv_layout``:

      * "heads": each rank runs its own query heads against its own KV
        heads (its cache shard), no collective;
      * "gather" / a prefill building a "seq" or "replicated" cache: K and
        V all-gathered over "model" (and q too where the query heads do
        not divide it), each rank running the heads its wo rows read;
      * "seq" decode: q and the new token's K and V all-gathered, the row
        written by the rank that holds slot pos % W, every head's partial
        softmax over the rank's W/m rows combined with one MAX and one SUM
        all-reduce (``decode_attention/ref.py``'s ``combine_partials``);
      * "replicated" decode: q, K and V all-gathered, every rank holding
        the whole cache.

    The kernels (B2, B3; the "seq" decode B3's split pass alone) or their
    plain versions run inside, as on one device."""
    from torch.distributed.tensor import Shard
    m = sh.axis_size("model")
    Hq = cfg.num_heads if num_heads is None else num_heads
    width = cache["k"].shape[1] if cache is not None else build_cache_w
    layout = kv_layout(cfg, m, width)
    act = xn.placements
    ws = (p["wq"], p["wk"], p["wv"], p["wo"])
    if not (sh.model_sharded(p["wq"]) and sh.model_sharded(p["wo"])):
        raise NotImplementedError("a sharded attention needs Hq·D to "
                                  "divide the model axis")
    if layout == "heads":
        fn = _heads_local(cfg, m, Hq, pos, build_cache_w, plain,
                          prefix_len)
    elif cache is None:
        fn = _gather_local(cfg, m, Hq, build_cache_w, layout, plain,
                           prefix_len, sh.model_sharded(p["wk"]))
    else:
        fn = _gather_decode_local(cfg, m, Hq, pos, layout, plain,
                                  sh.model_sharded(p["wk"]))
    y_pl = sh.partial_model(act)
    if cache is not None:
        y = sh.local_site(fn, y_pl, xn, *ws, positions, cache["k"],
                          cache["v"], weights=(1, 2, 3, 4))
        return y, cache
    if build_cache_w is None:
        return sh.local_site(fn, y_pl, xn, *ws, positions,
                             weights=(1, 2, 3, 4)), None
    if layout == "replicated":
        kv_pl = sh.replicate_model(act)
    else:
        kv_pl = sh.with_model(act, Shard(2 if layout == "heads" else 1))
    y, ck, cv = sh.local_site(fn, (y_pl, kv_pl, kv_pl), xn, *ws, positions,
                              weights=(1, 2, 3, 4))
    return y, {"k": ck, "v": cv}


def _heads_local(cfg, m, Hq, pos, build_cache_w, plain, prefix_len):
    """The "heads" layout's local function: ``attention_apply``'s branches
    on the rank's Hq/m query and Hkv/m KV heads."""
    Hq, Hkv = Hq // m, cfg.num_kv_heads // m

    def local(xn, wq, wk, wv, wo, positions, *kv):
        B, S, _ = xn.shape
        q, k, v = _qkv(cfg, {"wq": wq, "wk": wk, "wv": wv}, xn, positions,
                       Hq, Hkv, copy=sh.copy_to_model)
        cache = {"k": kv[0], "v": kv[1]} if kv else None
        out, cache_out = _attend(cfg, q, k, v, cache, pos, build_cache_w,
                                 plain, prefix_len)
        y = out.reshape(B, S, -1) @ wo
        if kv or cache_out is None:
            return y
        return y, cache_out["k"], cache_out["v"]

    return local


def _wo_span(cfg, Hq: int, cols: int):
    """The rank's columns of the attention output (its wo rows): [c0,
    c0 + cols), the heads [h_lo, h_hi) of Hq that cover them and the KV
    heads [k_lo, k_hi) those read."""
    D, G = cfg.head_dim, Hq // cfg.num_kv_heads
    c0 = sh.model_rank() * cols
    h_lo, h_hi = c0 // D, -(-(c0 + cols) // D)
    k_lo, k_hi = h_lo // G, (h_hi - 1) // G + 1
    g = (h_hi - h_lo) // (k_hi - k_lo)
    # the span's grouping must send each head to its own KV head
    if (h_hi - h_lo) % (k_hi - k_lo) or any(
            (h_lo + i) // G - k_lo != i // g for i in range(h_hi - h_lo)):
        raise NotImplementedError(
            f"query heads [{h_lo}, {h_hi}) do not group over KV heads "
            f"[{k_lo}, {k_hi})")
    return c0, h_lo, h_hi, k_lo, k_hi


def _gather_posts(names):
    """``_qkv``'s ``post`` that all-gathers the named projections'
    column-parallel shards over "model"."""
    return {name: (lambda t: sh.gather_model(t, -1)) for name in names}


def _gather_local(cfg, m, Hq, build_cache_w, layout, plain, prefix_len,
                  k_sharded):
    """The local function of a full-sequence pass whose KV heads do not
    divide "model": each rank runs the heads its wo rows read against the
    gathered K/V, and keeps its rows of the ring cache ("seq") or all of
    it ("replicated")."""

    def local(xn, wq, wk, wv, wo, positions):
        B, S, _ = xn.shape
        cols = wo.shape[0]
        c0, h_lo, h_hi, k_lo, k_hi = _wo_span(cfg, Hq, cols)
        # every KV head; q of heads [h_lo, h_hi), gathered first where the
        # query heads do not divide "model" either
        D = cfg.head_dim
        post = _gather_posts(("wk", "wv") if k_sharded else ())
        if Hq % m:
            post["wq"] = lambda t: sh.gather_model(t, -1)[
                ..., h_lo * D:h_hi * D]
        q, k, v = _qkv(cfg, {"wq": wq, "wk": wk, "wv": wv}, xn, positions,
                       h_hi - h_lo, cfg.num_kv_heads, copy=sh.copy_to_model,
                       post=post)
        out, _ = _attend(cfg, q, k[:, :, k_lo:k_hi], v[:, :, k_lo:k_hi],
                         None, None, None, plain, prefix_len)
        off = c0 - h_lo * cfg.head_dim
        y = out.reshape(B, S, -1)[..., off:off + cols] @ wo
        if build_cache_w is None:
            return y
        ring = build_ring_cache(k, v, build_cache_w)
        if layout == "seq":
            rows = build_cache_w // m
            lo = sh.model_rank() * rows
            ring = {key: val[:, lo:lo + rows].contiguous()
                    for key, val in ring.items()}
        return y, ring["k"], ring["v"]

    return local


def _gather_decode_local(cfg, m, Hq, pos, layout, plain, k_sharded):
    """The local function of a decode step whose KV heads do not divide
    "model" ("seq" or "replicated" cache): q, K and V of the new token
    all-gathered, every head attended, the rank's wo columns kept."""

    def local(xn, wq, wk, wv, wo, positions, ck, cv):
        B = xn.shape[0]
        cols = wo.shape[0]
        c0 = sh.model_rank() * cols
        post = _gather_posts(("wq", "wk", "wv") if k_sharded else ("wq",))
        q, k, v = _qkv(cfg, {"wq": wq, "wk": wk, "wv": wv}, xn, positions,
                       Hq, cfg.num_kv_heads, post=post)
        if layout == "replicated":
            out, _ = _attend(cfg, q, k, v, {"k": ck, "v": cv}, pos, None,
                             plain, 0)
        else:
            out = _seq_parallel_attention(q[:, 0], k, v, ck, cv, pos, m,
                                          plain)
        return out.reshape(B, 1, -1)[..., c0:c0 + cols] @ wo

    return local


def ring_partials_plain(q, ck, cv, lengths):
    """The plain split pass of the ring-cache decode (B3's split pass on
    the card): the f32 partials (max, sum, unnormalised accumulator) of
    each SPLIT_KEYS-row split of ck, cv over their first lengths[b]
    rows."""
    return split_partials(q, ck, cv, lengths, SPLIT_KEYS)


def _seq_parallel_attention(q, k, v, ck, cv, pos, m: int, plain: bool):
    """Sequence-parallel decode of one token against this rank's W/m rows
    ck, cv [B, W/m, Hkv, D] of the ring cache: the rank that holds slot
    pos % W writes k, v [B, 1, Hkv, D] there; B3's split pass (or its
    plain version) gives the partials of the rank's valid rows, a prefix
    of them as of the whole ring, and one MAX and one SUM all-reduce over
    "model" combine them (``decode_attention/ref.py``'s
    ``combine_partials`` across ranks).  q [B, Hq, D] -> out [B, Hq, D]
    in q's type."""
    B, Hq, D = q.shape
    rows = ck.shape[1]
    W = rows * m
    lo = sh.model_rank() * rows
    dev = q.device
    pos = torch.as_tensor(pos, device=dev).long()
    slot = pos % W - lo
    mine = (slot >= 0) & (slot < rows)
    at = slot.clamp(0, rows - 1).reshape(1)
    for cache, new in ((ck, k), (cv, v)):
        old = cache.index_select(1, at)
        cache.index_copy_(1, at, torch.where(mine, new, old))
    lengths = (layers.decode_lengths(W, pos, B, dev) - lo).clamp(
        0, rows).to(torch.int32)
    split = ring_partials_plain if plain else decode_attention_partials
    pm, pl, pacc = split(q.contiguous(), ck, cv, lengths)
    # a split past the rank's rows holds nothing the kernel wrote
    ns = pm.shape[-1]
    live = (torch.arange(ns, device=dev)[None] <
            (-(-lengths.long() // SPLIT_KEYS))[:, None])[:, None]
    pm = torch.where(live, pm, layers.NEG_INF)
    mx = sh.max_model(pm.amax(-1))                              # [B, Hq]
    f = torch.where(live, torch.exp(pm - mx[..., None]), 0.0)
    l_sum = (torch.where(live, pl, 0.0) * f).sum(-1)
    acc = (torch.where(live[..., None], pacc, 0.0) * f[..., None]).sum(-2)
    la = sh.reduce_model(torch.cat([l_sum[..., None], acc], dim=-1))
    out = la[..., 1:] / la[..., :1].clamp_min(1e-30)
    return out.to(q.dtype)
