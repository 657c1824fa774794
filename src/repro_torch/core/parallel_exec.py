"""Explicit tensor-parallel and pipeline engines of the port, on virtual
ranks and stages or on real ones.

Counterpart of ``repro.core.parallel_exec``.  The TP half is the paper's
hand-placed collective schedule (Section III-A) —

  * a vocab-parallel embedding all-reduce (the "+1"),
  * per layer one all-reduce after the attention output projection and
    one after the MLP down-projection (2L),
  * an all-gather of the vocab-sharded logits (the paper's Gather; the
    JAX package all-gathers, ``commodel`` gather_mode="allgather").

By default the t ranks are virtual: their shards sit on one device and
every collective goes through a ``core.comm.VirtualGroup``, which logs it.
So one card (or the CPU) runs t > 1, and a run's log compares with
``commodel.comm_ops_for``.  On a ``core.comm.DistGroup`` (``group=``) the
same code runs one rank per process and card, its collectives over NCCL
(gloo on the CPU): every rank loop runs over ``group.local_ranks``, all t
on a virtual group and this process's one rank on a real one, and the
parameter and cache lists hold the local ranks' pieces only.  The rank
loop:

  * each rank runs its own shard's projections and attention (kernels B2,
    B3 and B4 at Hq/t query and Hkv/t KV heads) and contributes a partial
    sum; the layer keeps the list of the t partials;
  * work whose result is the same on every rank runs once on the group:
    the norms with the residual adds before them (B1, ``add_rms_norm``:
    each all-reduce's add runs inside the norm after it, as in
    ``models.blocks``), the embedding after its all-reduce and the
    dequantize after the gather;
  * ``quantized_psum`` (``quant`` = "int8" | "fp8" | "int4") replaces each
    per-layer all-reduce of a contiguous decode step by the quantized
    two-step (kernels B5–B9).  On the int8/fp8 wire the layer keeps the
    gathered payload and its scales (``GatheredSum``) and the next norm
    site dequantizes, adds and normalises them in one kernel
    (``dequantize_add_rms_norm``).  Prefill, the paged passes, the
    embedding all-reduce and the logits gather stay full-width, as in the
    JAX package.

Context parallelism (``c`` > 1, prefill only) shards a prefill's sequence
over c virtual CP workers on top of the t ranks (a (t, c) mesh): every
worker runs each layer on its [B, S/c, h] shard, its K/V blocks
ring-exchanged over the CP group (``layers.ring_kv_assemble``) so that B2
attends at the shard's offset over the whole sequence in absolute order,
and one CP all-reduce hands the last position's hidden state to the head.
The TP collectives of the c shards at one site are logged once, as the
SPMD program shows them per rank (``core.comm``).  Decode and the paged
passes are the c = 1 passes at any c: the assembled cache is whole on
every worker.  On real ranks (``cp_group`` a ``core.comm.DistGroup``)
each process is one (TP rank, CP worker) of the (t, c) plane: it runs
its own shard of the prompt, rings its K/V with its CP peers, and decodes
replicated over cp with its own TP group on its whole cache.

Parameters of a TP model are a list of t per-rank dicts (``shard_params``);
caches are a list of t per-rank dicts {k, v: [L, B, W, Hkv/t, D]} (ring
cache) or {k, v: [L, P, ps, Hkv/t, D]} (KV pages under one block table).
Like the JAX engine this covers the dense llama family with untied,
unscaled embeddings (the JAX ``_head`` and ``_embed_tokens`` ignore
``tie_embeddings`` and ``scale_embedding``); other configs raise.

The pipeline half (Section III-B/C) is ``PipelineEngine``: p stages, each
a ``TPModel`` stage over its own layers and its own t ranks (t = 1: pure
PP, t > 1: hybrid), with a logged boundary hop between stages.  A TPModel
pass is the one-stage case of the same stage methods.  Given a
``core.comm.RankPlace`` (``place=``) each process runs its own stage on
its own card, and a hop is an NCCL send/recv to the next stage.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import types
from typing import List, NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch.config.base import ModelConfig
from repro_torch.core.comm import DistGroup, VirtualGroup
from repro_torch.core.commodel import (DEFAULT_QUANT_CHUNK,
                                       stage_layer_partition)
from repro_torch.kernels.quant_collective import ref as qref
from repro_torch.kernels.quant_collective.ops import (
    QUANT_DTYPES, chunk_amax, chunk_dequantize, chunk_quantize_pack_shared,
    chunk_quantize_shared, collective_qmax, dequantize_add_rms_norm,
    nibble_reduce_requant, nibble_unpack_dequantize)
from repro_torch.models.blocks import attention_apply
from repro_torch.models.layers import (add_norm, decode_positions, mlp_apply,
                                       torch_dtype)
from repro_torch.models.transformer import (Model, greedy_decode_loop,
                                            greedy_tokens, resolve_device)
from repro_torch.runtime.engine import check_params_device

# ---------------------------------------------------------------------------
# parameter sharding (the slicing counterpart of tp_param_specs)
# ---------------------------------------------------------------------------

# axis each parameter is split on (None: replicated on every rank).
# Column-parallel wq/wk/wv/w1/w3 split their output axis, row-parallel
# wo/w2 their input axis, the vocab-parallel embed/lm_head the vocab axis.
BLOCK_SHARD_AXES = {"wq": 2, "wk": 2, "wv": 2, "w1": 2, "w3": 2,
                    "wo": 1, "w2": 1, "ln1": None, "ln2": None}
TOP_SHARD_AXES = {"embed": 0, "lm_head": 1, "final_norm": None}


def check_tp_config(cfg: ModelConfig, t: int) -> None:
    """Raise unless the TP engine covers ``cfg`` at degree ``t``."""
    if cfg.family != "dense":
        raise ValueError(f"the explicit TP engine covers the dense family; "
                         f"{cfg.name} is {cfg.family}")
    if cfg.tie_embeddings or cfg.scale_embedding:
        raise ValueError(
            f"{cfg.name} sets tie_embeddings={cfg.tie_embeddings} "
            f"scale_embedding={cfg.scale_embedding}: the TP engine, like "
            "the JAX package's (its _head and _embed_tokens ignore both), "
            "covers untied, unscaled embeddings only")
    if t < 1:
        raise ValueError(f"t must be >= 1, got {t}")
    for what, n in (("num_heads", cfg.num_heads),
                    ("num_kv_heads", cfg.num_kv_heads),
                    ("d_ff", cfg.d_ff), ("padded_vocab", cfg.padded_vocab)):
        if n % t:
            raise ValueError(f"{cfg.name}: {what}={n} does not divide over "
                             f"t={t} ranks")


def shard_params(cfg: ModelConfig, params: dict, t: int,
                 ranks=None) -> List[dict]:
    """Rank r's slice of every parameter, as a contiguous copy of its own:
    what ``NamedSharding(mesh, tp_param_specs(cfg))`` places on device r.
    Replicated parameters are copied to every rank too.  ``ranks`` (default
    all t) are the ranks whose slices are made: a process of a real group
    keeps its own rank's only.  A top-level parameter ``params`` lacks (a
    pipeline stage's) is left out."""
    check_tp_config(cfg, t)

    def piece(w, axis, r):
        if axis is not None:
            n = w.shape[axis] // t
            w = w.narrow(axis, r * n, n)
        return w.clone(memory_format=torch.contiguous_format)

    return [dict({name: piece(params[name], axis, r)
                  for name, axis in TOP_SHARD_AXES.items() if name in params},
                 blocks={name: piece(w, BLOCK_SHARD_AXES[name], r)
                         for name, w in params["blocks"].items()})
            for r in (range(t) if ranks is None else ranks)]


# ---------------------------------------------------------------------------
# collectives of the schedule
# ---------------------------------------------------------------------------


def _vocab_parallel_embed(embeds, tokens, group: VirtualGroup):
    """Vocab-sharded embedding lookup + all-reduce (the paper's '+1'): rank
    r looks up the tokens of its vocab block and zeros the others."""
    vshard = embeds[0].shape[0]
    tokens = tokens.long()
    parts = []
    for r, table in zip(group.local_ranks, embeds):
        local = tokens - r * vshard
        valid = (local >= 0) & (local < vshard)
        x = table[local.clamp(0, vshard - 1)]
        parts.append(torch.where(valid[..., None], x, torch.zeros_like(x)))
    return group.all_reduce(parts)


_KERNEL_OPS = types.SimpleNamespace(
    amax=chunk_amax, quantize_shared=chunk_quantize_shared,
    dequantize=chunk_dequantize, dequantize_add_norm=dequantize_add_rms_norm,
    quantize_pack_shared=chunk_quantize_pack_shared,
    reduce_requant=nibble_reduce_requant,
    unpack_dequantize=nibble_unpack_dequantize)
_PLAIN_OPS = types.SimpleNamespace(
    amax=qref.chunk_amax_ref,
    quantize_shared=lambda x, amax, qmax, chunk, quant, write:
        qref.chunk_quantize_shared_ref(x, amax, qmax, chunk,
                                       QUANT_DTYPES[quant], write),
    dequantize=qref.chunk_dequantize_ref,
    dequantize_add_norm=qref.dequantize_add_rms_norm_ref,
    quantize_pack_shared=qref.chunk_quantize_pack_shared_ref,
    reduce_requant=qref.nibble_reduce_requant_ref,
    unpack_dequantize=qref.nibble_unpack_dequantize_ref)


class GatheredSum(NamedTuple):
    """The int8/fp8 all-reduce's result before its dequantize: the
    gathered wire payload [..., h] and the shared scales [..., K] it is
    dequantized with (``chunk`` wide, ``plain`` for the plain versions)."""
    q: torch.Tensor
    scales: torch.Tensor
    chunk: int
    plain: bool

    def dequantize(self, dtype):
        ops = _PLAIN_OPS if self.plain else _KERNEL_OPS
        return ops.dequantize(self.q, self.scales, self.chunk, dtype)

    def add_norm(self, x, weight, eps: float):
        """(s, n) = (x + the dequantized sum, rms_norm(s)), one kernel on
        the card."""
        ops = _PLAIN_OPS if self.plain else _KERNEL_OPS
        return ops.dequantize_add_norm(self.q, self.scales, self.chunk, x,
                                       weight, eps)

    def last(self):
        """The last position of every sequence ([B, S, ...] -> [B, ...])."""
        return self._replace(q=self.q[:, -1], scales=self.scales[:, -1])


def _check_quant(quant):
    if quant is not None and quant not in QUANT_DTYPES:
        raise ValueError(f"unknown quant_collectives mode {quant!r}; "
                         f"expected None or one of {sorted(QUANT_DTYPES)}")
    return quant


def quantized_psum(xs, group: VirtualGroup, quant: str = "int8",
                   chunk: int = DEFAULT_QUANT_CHUNK, plain: bool = False):
    """Quantized two-step all-reduce of the t rank tensors xs [..., h]
    (``quantized_psum_gathered``), dequantized: the one tensor every rank
    holds."""
    out = quantized_psum_gathered(xs, group, quant, chunk, plain)
    if isinstance(out, GatheredSum):
        return out.dequantize(xs[0].dtype)
    return out


def quantized_psum_gathered(xs, group: VirtualGroup, quant: str = "int8",
                            chunk: int = DEFAULT_QUANT_CHUNK,
                            plain: bool = False):
    """Quantized two-step all-reduce of the t rank tensors xs [..., h].

      1. per-chunk abs-max on every rank (B5), all-reduced with max; the
         shared scales follow from it (``scales_from_amax`` with
         ``collective_qmax`` headroom) inside the quantize, on every rank,
         and the first local rank's quantize also writes them for the
         dequantize: rank 0 on a virtual group, every process's own rank
         on a ``DistGroup``;
      2. int8 / fp8: quantize on every rank (B6) onto the shared scales,
         reduce-scatter of the 1-byte payload (the int8 sum is exact by
         the headroom), all-gather of the reduced blocks; the gathered
         payload and scales are returned as a ``GatheredSum``, which
         dequantizes once (B9) back to the inputs' dtype, or with the
         residual add and the next norm (``GatheredSum.add_norm``);
      3. int4, three fused passes around the two hops: quantize and pack
         on every rank (B6 + B7; the first local rank's writes the shared
         scales times t), all-to-all of the nibbles; on every rank
         unpack, an exact int32 sum of the t copies of the rank's block,
         requantize by t and pack again (B8 + B7); all-gather; unpack and
         dequantize once (B8 + B9) with the shared scales times t.

    ``quant=None`` or a group of one rank is the plain all-reduce.
    ``plain=True`` runs the plain versions of the passes in place of the
    kernels.  Returns the one tensor every rank holds, or (int8 / fp8) its
    ``GatheredSum``.
    """
    t = group.t
    if quant is None or t <= 1:
        return group.all_reduce(xs)
    h = xs[0].shape[-1]
    if h % t:
        raise ValueError(f"quantized_psum scatters the hidden axis over "
                         f"t={t}: h={h} must divide")
    ops = _PLAIN_OPS if plain else _KERNEL_OPS
    amax = group.all_reduce([ops.amax(x, chunk) for x in xs], op="max")
    qmax = collective_qmax(quant, t)
    if quant == "int4":
        if h % (2 * t):
            raise ValueError(f"int4 packs two values per byte and ships "
                             f"h/t-element blocks: h={h} must divide 2t="
                             f"{2 * t}")
        out = [ops.quantize_pack_shared(x, amax, qmax, chunk, t, i == 0)
               for i, x in enumerate(xs)]
        received = group.all_to_all([p for p, _ in out], values_per_item=2)
        reduced = [ops.reduce_requant(p, t) for p in received]
        gathered = group.all_gather(reduced, values_per_item=2)
        return ops.unpack_dequantize(gathered, out[0][1], chunk,
                                     xs[0].dtype)
    out = [ops.quantize_shared(x, amax, qmax, chunk, quant, i == 0)
           for i, x in enumerate(xs)]
    gathered = group.all_gather(group.reduce_scatter([q for q, _ in out]))
    return GatheredSum(gathered, out[0][1], chunk, plain)


def _add_norm(x, h, weight, eps: float, plain: bool):
    """A norm site on the TP group: (s, n) with s = x + h, n =
    rms_norm(s); h is None (no add), an all-reduced tensor, or a
    ``GatheredSum`` (dequantized inside the same kernel)."""
    if isinstance(h, GatheredSum):
        return h.add_norm(x, weight, eps)
    return add_norm(x, h, weight, eps, plain)


def _mask_pad_vocab(logits, vocab: int):
    """Mask pad-vocab columns to the logits' own dtype minimum."""
    if vocab >= logits.shape[-1]:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col < vocab, logits, torch.finfo(logits.dtype).min)


def _logits_allgather(params, carried, group: VirtualGroup, vocab: int,
                      eps: float, plain: bool):
    """Final norm once at the last position, closing the last layer's
    residual add there (``carried`` is the trunk's (h, x)), vocab-sharded
    logits per rank, all-gather."""
    h, x = carried
    if isinstance(h, GatheredSum):
        h = h.last()
    elif h is not None:
        h = h[:, -1]
    _, xn = _add_norm(x[:, -1], h, params[0]["final_norm"], eps, plain)
    logits = group.all_gather([xn @ p["lm_head"] for p in params])
    return _mask_pad_vocab(logits, vocab)


def _layer_slice(blocks, l):
    return {k: v[l] for k, v in blocks.items()}


def pad_to_multiple(tokens, c: int):
    """tokens [B, S] padded on the right with token 0 to a multiple of c
    (the JAX package's CP padding)."""
    pad = -tokens.shape[1] % c
    return torch.nn.functional.pad(tokens, (0, pad)) if pad else tokens


def check_cp_tokens(tokens, c: int) -> None:
    if tokens.shape[1] % c:
        raise ValueError(
            f"CP prefill shards the sequence over c={c}: pad the prompt to a "
            f"multiple of c (got S={tokens.shape[1]})")


# ---------------------------------------------------------------------------
# the TP model
# ---------------------------------------------------------------------------


class TPModel:
    """The dense model of ``cfg`` over t virtual TP ranks, with the
    interface of ``models.transformer.Model`` on per-rank parameters and
    caches.  ``quant`` lowers the per-layer all-reduces of the contiguous
    decode step to ``quantized_psum``; ``plain=True`` runs the plain
    attention, RMSNorm and quantization in place of the kernels.  The
    collectives go through ``group`` (default a ``VirtualGroup(t)``; a
    ``DistGroup`` runs this process's rank only) and are logged on
    ``self.group``.  The layer loop carries the
    residual stream as (h, x) (``models.blocks``): h is the last all-reduce
    of the previous layer, added inside the next norm.  ``c`` > 1 adds c
    CP workers to the prefill (``cp_prefill``); their ring and all-reduce
    go through ``self.cp_group``, which logs into ``self.group.log``: a
    ``VirtualGroup(c)`` by default, or ``cp_group``, the CP ``DistGroup``
    of a rank placed by ``core.comm.dist_groups`` (which a ``DistGroup``
    ``group`` at c > 1 needs), whose process then runs its own worker's
    shard only."""

    def __init__(self, cfg: ModelConfig, t: int, quant: str = None,
                 quant_chunk: int = DEFAULT_QUANT_CHUNK, plain: bool = False,
                 c: int = 1, group: VirtualGroup = None,
                 cp_group: VirtualGroup = None):
        check_tp_config(cfg, t)
        if c < 1:
            raise ValueError(f"c must be >= 1, got {c}")
        if group is not None and group.t != t:
            raise ValueError(f"a group of {group.t} ranks for t={t}")
        if cp_group is not None and cp_group.t != c:
            raise ValueError(f"a CP group of {cp_group.t} workers for c={c}")
        if c > 1 and isinstance(group, DistGroup) and cp_group is None:
            raise ValueError("a rank's TP group at c > 1 needs its CP group "
                             "(core.comm.dist_groups(t, p, c=c).cp_group)")
        self.cfg = cfg
        self.t = int(t)
        self.c = int(c)
        self.quant = _check_quant(quant)
        self.quant_chunk = int(quant_chunk)
        self.plain = bool(plain)
        self.heads_t = cfg.num_heads // t
        self.kv_t = cfg.num_kv_heads // t
        self.group = VirtualGroup(t) if group is None else group
        self.cp_group = VirtualGroup(c, log=self.group.log) \
            if cp_group is None else cp_group
        self._dense = Model(cfg, plain)

    # ------------------------------------------------------------- params
    def init(self, seed: int = 0, device=None) -> List[dict]:
        """Seeded random weights (``Model.init``), sharded over the local
        ranks."""
        return shard_params(self.cfg, self._dense.init(seed, device), self.t,
                            self.group.local_ranks)

    def cache_width(self, max_len: int) -> int:
        return self._dense.cache_width(max_len)

    def init_cache(self, batch: int, max_len: int, device=None):
        return self._rank_caches((self.cfg.num_layers, batch,
                                  self.cache_width(max_len)), device)

    def init_paged_cache(self, num_pages: int, page_size: int, device=None):
        """Per-rank [L, P, ps, Hkv/t, D] K/V page pools (page 0 is the
        scratch page — runtime/kvpool.py)."""
        if self.cfg.sliding_window:
            raise ValueError(
                "paged KV cache keeps every position (pages, no ring wrap); "
                f"{self.cfg.name} uses a sliding window — serve it "
                "contiguous")
        return self._rank_caches((self.cfg.num_layers, num_pages, page_size),
                                 device)

    def _rank_caches(self, lead, device):
        device = resolve_device(device)
        shape = (*lead, self.kv_t, self.cfg.head_dim)
        return [{key: torch.zeros(shape, dtype=torch_dtype(self.cfg.dtype),
                                  device=device)
                 for key in ("k", "v")} for _ in self.group.local_ranks]

    # ------------------------------------------------------ layer variants
    def _tp_layer_qkv(self, pls, xn, positions, caches=None, **attn_kw):
        """Every rank's projection head and attention: RoPE'd q/k/v of the
        rank's heads and the attention kernel over them
        (``blocks.attention_apply`` at Hq/t and Hkv/t heads).  Returns the
        per-rank outputs [B, S, Hq/t*D] and caches.  Each rank runs its own
        CP ring (with ``cp_group``), logged once for the t ranks."""
        outs, new = [], []
        for r, p in enumerate(pls):
            with self.cp_group.muted(r > 0):
                out, cache = attention_apply(
                    self.cfg, p, xn, positions,
                    cache=None if caches is None else caches[r],
                    plain=self.plain, num_heads=self.heads_t,
                    num_kv_heads=self.kv_t, **attn_kw)
            outs.append(out)
            new.append(cache)
        return outs, new

    def _tp_layer_in(self, pls, carried):
        """ln1 on the carried pair (h, x): the previous layer's last
        all-reduce added, then normalised.  Returns (x, xn)."""
        h, x = carried
        return _add_norm(x, h, pls[0]["ln1"], self.cfg.norm_eps, self.plain)

    def _psum(self, xs, quant):
        return quantized_psum_gathered(xs, self.group, quant,
                                       self.quant_chunk, self.plain)

    def _tp_layer_out(self, pls, x, attns, quant: str = None):
        """The attention-output and MLP residual tail: the layer's two
        all-reduces (``quantized_psum`` when ``quant`` is set).  The first
        is added inside ln2; the second is returned unadded, as the carried
        pair (h, x)."""
        cfg = self.cfg
        h = self._psum([a @ p["wo"] for a, p in zip(attns, pls)],
                       quant)                                   # AR (attn out)
        x, xn2 = _add_norm(x, h, pls[0]["ln2"], cfg.norm_eps, self.plain)
        return (self._psum([mlp_apply(p, xn2, cfg.activation) for p in pls],
                           quant), x)                           # AR (mlp down)

    def _tp_layer_full(self, pls, x, positions, cache_w=None):
        """One layer over a full sequence (the prefill), on the carried
        pair x = (h, x); with ``cache_w`` each rank's ring cache of width
        cache_w is built from its K/V."""
        x, xn = self._tp_layer_in(pls, x)
        attns, caches = self._tp_layer_qkv(pls, xn, positions,
                                           build_cache_w=cache_w)
        return self._tp_layer_out(pls, x, attns), caches

    def _cp_layer_full(self, pls, shards, positions, cache_w=None):
        """One layer of a context-parallel prefill over the c shards'
        carried pairs: ln1 per shard, every rank's CP attention (the ring
        and B2 at each shard's offset; ``blocks.attention_apply`` with
        ``cp_group``), the residual tail per shard.  The c shards' TP
        collectives at a site are logged once.  Returns (the c shards'
        pairs, per-rank ring caches built from the assembled K/V)."""
        ins = []
        for i, carried in enumerate(shards):
            with self.group.muted(i > 0):
                ins.append(self._tp_layer_in(pls, carried))
        attns, caches = self._tp_layer_qkv(
            pls, [xn for _, xn in ins], positions, cp_group=self.cp_group,
            build_cache_w=cache_w)
        out = []
        for i, (x, _) in enumerate(ins):
            with self.group.muted(i > 0):
                out.append(self._tp_layer_out(pls, x, [a[i] for a in attns]))
        return out, caches

    def _cp_last_hidden(self, shards, last: int):
        """The carried pair the head reads at absolute position ``last``:
        the local shard that owns it adds its pair on that row (``x + h``,
        the s of the norm that closes it), every other shard contributes
        zeros, and one all-reduce over the CP group (the "+1" of
        ``commodel.cp_comm_ops``) hands the row to every worker; the final
        norm is then B1 alone.  ``shards`` are the local workers' pairs
        (``cp_group.local_ranks``)."""
        s = shards[0][1].shape[1]
        owner, i = divmod(int(last), s)
        rows = []
        for r, (h, x) in zip(self.cp_group.local_ranks, shards):
            if r != owner:
                rows.append(torch.zeros_like(x[:, 0]))
            else:
                rows.append(x[:, i] if h is None else x[:, i] + h[:, i])
        return None, self.cp_group.all_reduce(rows)[:, None]

    def _tp_layer_step(self, pls, x, positions, pos, caches):
        """One decode step against the per-rank ring caches (in place);
        the two all-reduces quantized when the model has ``quant``."""
        x, xn = self._tp_layer_in(pls, x)
        attns, caches = self._tp_layer_qkv(pls, xn, positions, caches=caches,
                                           pos=pos)
        return self._tp_layer_out(pls, x, attns, self.quant), caches

    def _tp_layer_paged(self, pls, x, positions, pos, caches, block_table):
        """One layer of a paged pass (a prefill chunk or a decode token):
        each rank's K/V rows go into its own page pool at the pages the
        shared block table names.  Paging is data movement, not
        communication: the collectives are the contiguous layer's."""
        x, xn = self._tp_layer_in(pls, x)
        attns, caches = self._tp_layer_qkv(pls, xn, positions, caches=caches,
                                           pos=pos, block_table=block_table)
        return self._tp_layer_out(pls, x, attns), caches

    def _embed_tokens(self, params, tokens):
        return _vocab_parallel_embed([p["embed"] for p in params], tokens,
                                     self.group)

    def _head(self, params, carried):
        return _logits_allgather(params, carried, self.group,
                                 self.cfg.vocab_size, self.cfg.norm_eps,
                                 self.plain)

    @staticmethod
    def _layer_caches(cache, l):
        return [{key: c[key][l] for key in ("k", "v")} for c in cache]

    # ------------------------------------------------------------- stages
    # A stage runs the layers [lo, hi) on per-rank parameters whose blocks
    # hold exactly those layers (``PipelineEngine.prepare``) and on caches
    # of those layers.  The stage that owns layer 0 embeds the tokens; a
    # later one takes the carried pair its predecessor shipped.  The stage
    # that owns the last layer ends in the head; an earlier one returns the
    # carried pair for the boundary.  TPModel's own passes are the one
    # stage [0, L).

    def _stage_in(self, params, inp, lo: int):
        """The carried pair (h, x) a stage starts from: the embedded tokens
        (``lo`` = 0), or the pair received at the stage boundary as t
        per-rank h/t slices of each tensor, all-gathered on the group (two
        all-gathers at t > 1)."""
        if lo == 0:
            return None, self._embed_tokens(params, inp)
        h, x = inp
        return self.group.all_gather(h), self.group.all_gather(x)

    def _stage_out(self, params, carried, hi: int):
        if hi == self.cfg.num_layers:
            return self._head(params, carried)
        return carried

    def stage_prefill(self, params, inp, lo: int, hi: int,
                      cache_w: int = None, last: int = None):
        """Layers [lo, hi) over whole sequences: (out, per-rank ring caches
        [hi - lo, B, cache_w, Hkv/t, D], or None without ``cache_w``).

        At c > 1 the sequence is sharded over the c CP workers: ``inp`` is
        the tokens [B, S] (S a multiple of c) on the first stage and the
        local workers' received pairs on a later one; each local worker
        (all c on virtual ranks, this process's one on a real rank) runs
        its own shard.  A stage that is not the last returns the local
        shards' pairs, and the last one's logits are those of position
        ``last`` (default S - 1)."""
        cfg, c = self.cfg, self.c
        workers = self.cp_group.local_ranks
        with self.group.phase("prefill"):
            if c == 1:
                inp = [inp]
            elif lo == 0:
                s = inp.shape[1] // c
                inp = [inp[:, i * s:(i + 1) * s] for i in workers]
            shards = []
            for i, part in enumerate(inp):
                with self.group.muted(i > 0):
                    shards.append(self._stage_in(params, part, lo))
            x = shards[0][1]
            B, s = x.shape[:2]
            positions = [torch.arange(i * s, (i + 1) * s,
                                      device=x.device).expand(B, s)
                         for i in workers]
            cache = None
            if cache_w is not None:
                cache = [{key: x.new_zeros((hi - lo, B, cache_w, self.kv_t,
                                            cfg.head_dim))
                          for key in ("k", "v")}
                         for _ in self.group.local_ranks]
            for l in range(lo, hi):
                pls = [_layer_slice(p["blocks"], l - lo) for p in params]
                if c == 1:
                    carried, built = self._tp_layer_full(
                        pls, shards[0], positions[0], cache_w)
                    shards = [carried]
                else:
                    shards, built = self._cp_layer_full(pls, shards,
                                                        positions, cache_w)
                if cache is not None:
                    for rank, b in zip(cache, built):
                        rank["k"][l - lo] = b["k"]
                        rank["v"][l - lo] = b["v"]
            if c == 1:
                return self._stage_out(params, shards[0], hi), cache
            if hi < cfg.num_layers:
                return shards, cache
            last = c * s - 1 if last is None else last
            return self._head(params, self._cp_last_hidden(shards, last)), \
                cache

    def stage_decode(self, params, cache, inp, pos, lo: int, hi: int):
        """One decode step through layers [lo, hi): ``inp`` is tokens [B]
        on the first stage; the stage's ring caches are updated in place."""
        with self.group.phase("decode"):
            carried = self._stage_in(params, inp[:, None] if lo == 0 else inp,
                                     lo)
            x = carried[1]
            pos = torch.as_tensor(pos, device=x.device)
            positions = decode_positions(pos, x.shape[0], device=x.device)
            for l in range(lo, hi):
                pls = [_layer_slice(p["blocks"], l - lo) for p in params]
                carried, _ = self._tp_layer_step(
                    pls, carried, positions, pos,
                    self._layer_caches(cache, l - lo))
            return self._stage_out(params, carried, hi), cache

    def stage_paged(self, params, cache, inp, pos, block_table, lo: int,
                    hi: int):
        """One paged pass through layers [lo, hi), logged as a decode step
        when S == 1 and as prefill otherwise; ``inp`` is tokens [B, S] on
        the first stage.  The stage's page pools are updated in place."""
        S = inp.shape[1] if lo == 0 else inp[1][0].shape[1]
        with self.group.phase("decode" if S == 1 else "prefill"):
            carried = self._stage_in(params, inp, lo)
            x = carried[1]
            pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
            block_table = torch.as_tensor(block_table, dtype=torch.int32,
                                          device=x.device)
            positions = pos[:, None].long() + torch.arange(S,
                                                           device=x.device)
            for l in range(lo, hi):
                pls = [_layer_slice(p["blocks"], l - lo) for p in params]
                carried, _ = self._tp_layer_paged(
                    pls, carried, positions, pos,
                    self._layer_caches(cache, l - lo), block_table)
            return self._stage_out(params, carried, hi), cache

    # ---------------------------------------------------------- interface
    def tp_prefill(self, params, tokens, cache_w: int = None):
        """tokens [B, S] -> (last-position logits [B, v], per-rank ring
        caches of width ``cache_w``, or None).  Collectives: (2L+1)
        all-reduce + 1 all-gather (Eq. 1, Table III); at c > 1 this is
        ``cp_prefill`` at position S - 1."""
        return self.stage_prefill(params, tokens, 0, self.cfg.num_layers,
                                  cache_w)

    def cp_prefill(self, params, tokens, last: int = None,
                   cache_w: int = None):
        """Context-parallel prefill of padded tokens [B, S], S a multiple of
        c: (logits [B, v] of position ``last`` (default S - 1), per-rank
        ring caches of width ``cache_w`` built from the assembled K/V, or
        None).  Collectives: the TP schedule at the shard's [B, S/c] rows
        (t > 1) and ``commodel.cp_comm_ops``: 2L(c-1) collective-permutes
        and one CP all-reduce."""
        check_cp_tokens(tokens, self.c)
        return self.stage_prefill(params, tokens, 0, self.cfg.num_layers,
                                  cache_w, last)

    def tp_decode_step(self, params, cache, tokens, pos):
        """One decode step: tokens [B]; ``pos`` a scalar or [B] positions.
        Returns (logits [B, v], cache), the caches updated in place.
        Collectives: (2L+1) all-reduce + 1 all-gather; with ``quant`` each
        of the 2L layer all-reduces is the quantized two-step."""
        return self.stage_decode(params, cache, tokens, pos, 0,
                                 self.cfg.num_layers)

    def tp_generate(self, params, cache, tokens, pos, num_tokens: int):
        """Greedy multi-token decode: (tokens [B, num_tokens], cache)."""
        return greedy_decode_loop(
            lambda c, tok, p: self.tp_decode_step(params, c, tok, p),
            tokens, cache, pos, num_tokens)

    def tp_paged_step(self, params, cache, tokens, pos, block_table):
        """One paged pass over the per-rank page pools: a prefill chunk
        (S > 1, logged as prefill) or a decode step (S == 1, logged as
        decode).  tokens [B, S]; pos [B] start positions; block_table
        [B, n].  Returns (last-position logits [B, v], cache).  Runs
        full-width: the JAX package quantizes only the contiguous step."""
        return self.stage_paged(params, cache, tokens, pos, block_table, 0,
                                self.cfg.num_layers)

    # the single-device Model's names
    def prefill(self, params, tokens, max_len: int):
        """(logits [B, v], per-rank ring caches, S), as ``Model.prefill``;
        at c > 1 the prompts pad to a multiple of c with token 0 and run
        ``cp_prefill`` (the pad rows' K/V sit past position S - 1, where
        decode overwrites them)."""
        S = tokens.shape[1]
        return (*self.cp_prefill(params, pad_to_multiple(tokens, self.c),
                                 S - 1, self.cache_width(max_len)), S)

    decode_step = tp_decode_step
    decode_steps = tp_generate
    paged_step = tp_paged_step


# ---------------------------------------------------------------------------
# the pipeline (PP) and hybrid (TP x PP) engine, on virtual or real stages
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TransferRecord:
    """One tensor shipped across a stage boundary (the paper's Send)."""

    phase: str
    count: int                   # tensors moved
    shape: Tuple[int, ...]       # one worker's tensor: [B, S, h/t]
    dtype_bytes: int

    @property
    def bytes(self) -> int:
        return self.count * math.prod(self.shape) * self.dtype_bytes


def stage_layer_range(cfg: ModelConfig, p: int, s: int) -> Tuple[int, int]:
    """Layer interval [lo, hi) of stage s: ``commodel.stage_layer_partition``,
    which gives an indivisible remainder to the early stages."""
    sizes = stage_layer_partition(cfg.num_layers, p)
    lo = sum(sizes[:s])
    return lo, lo + sizes[s]


class PipelineEngine:
    """Pipeline (t = 1) or hybrid TP x PP (t > 1) engine: p stages on one
    device, each a ``TPModel`` over its own t virtual ranks and its own
    ``VirtualGroup`` (``self.stages[s].group`` logs the stage's
    collectives, the counterpart of the JAX engine's per-stage HLO).

    Stage s owns the layers ``stage_layer_range(cfg, p, s)``; stage 0 also
    embeds and the last stage runs the head.  A boundary hop ships the
    carried residual pair (h, x) — the vLLM (hidden_states, residual)
    pair; the JAX engine ships x·0.25 and x·0.75, the same bytes — and the
    receiving stage's first norm adds the two inside its kernel.  At t > 1
    each rank ships its h/t slice of both tensors and the receiving group
    all-gathers them.  On the int8/fp8 decode step the sender's last
    all-reduce is still a ``GatheredSum``: it is dequantized (B9) before
    the hop, once per boundary.  The hop is a device-to-device copy into
    the next stage's receive buffers (one pair per boundary and shape,
    allocated once), standing in for NCCL send/recv, and each of its two
    tensors is logged as a ``TransferRecord`` in ``self.transfers``.

    ``place`` (a ``core.comm.RankPlace`` of a world of t·c·p processes)
    puts the stages on real ranks: this process builds, holds and runs
    its own stage only (``self.stages`` and the per-stage lists hold None
    for the others), on its rank's shard, its TP ``DistGroup`` and, at
    c > 1, its CP ``DistGroup``.  A hop is then an ``isend``/``irecv`` of
    the rank's two [..., h/t] slices (a CP prefill's [B, S/c, h/t]) to the
    same (TP, CP) rank of the next stage, into the receive buffers; the
    sender logs the ``TransferRecord``s, so the records of the stages'
    first ranks add up to Eq. 2 / Eq. 7.  The last stage's logits stay
    there (on each of its CP workers); the next greedy token reaches every
    rank by one broadcast of B int32 from the last stage's first rank
    (``next_token``): the one message outside Eq. 2, not logged as a
    transfer.  The pass methods return the logits on the last stage and
    None elsewhere.

    ``quant_collectives`` quantizes the contiguous decode step's layer
    all-reduces, as in ``TPModel``; ``plain=True`` runs the plain versions
    of the kernels.  ``c`` > 1 shards each stage's prefill over c CP
    workers (``TPModel.cp_prefill``'s layers): the boundary pairs stay
    sequence-sharded, each worker shipping its [B, S/c, h/t] slices, and
    the last stage's head reads position ``last``; decode and the paged
    passes are the c = 1 passes."""

    def __init__(self, cfg: ModelConfig, t: int = 1, p: int = 2, c: int = 1,
                 quant_collectives: str = None,
                 quant_chunk: int = DEFAULT_QUANT_CHUNK, plain: bool = False,
                 device=None, place=None):
        if cfg.family != "dense":
            raise ValueError(f"PipelineEngine covers the dense family; "
                             f"{cfg.name} is {cfg.family}")
        check_tp_config(cfg, t)
        if not 1 <= p <= cfg.num_layers:
            raise ValueError(f"p must be in [1, {cfg.num_layers}] for "
                             f"{cfg.name}, got p={p}")
        self.cfg, self.t, self.p, self.c = cfg, int(t), int(p), int(c)
        self.quant = _check_quant(quant_collectives)
        self.quant_chunk = int(quant_chunk)
        self.place = place
        if place is None:
            self.device = resolve_device(device)
        else:
            if (place.t, place.c, place.p) != (self.t, self.c, self.p):
                raise ValueError(f"a rank placed at (t, c, p) = ({place.t}, "
                                 f"{place.c}, {place.p}) for an engine of "
                                 f"({t}, {c}, {p})")
            self.device = place.device
            if device is not None and torch.device(device) != self.device:
                raise ValueError(f"device {device} is not the rank's "
                                 f"{self.device}")
        self.stages = [TPModel(cfg, t, self.quant, quant_chunk, plain, c,
                               group=place and place.group,
                               cp_group=place and place.cp_group)
                       if place is None or place.stage == s else None
                       for s in range(p)]
        self.ranges = [stage_layer_range(cfg, p, s) for s in range(p)]
        self.transfers: List[TransferRecord] = []
        self._recv: dict = {}

    # ------------------------------------------------------------- state
    def prepare(self, params) -> List[List[dict]]:
        """Per stage, per local rank: the rank's shard (``shard_params``)
        of the stage's layers; the embedding on stage 0 only, the head and
        the final norm on the last stage only.  On real ranks only this
        process's stage and rank (None for the other stages)."""
        check_params_device(params, self.device)
        L = self.cfg.num_layers
        staged = []
        for m, (lo, hi) in zip(self.stages, self.ranges):
            if m is None:
                staged.append(None)
                continue
            part = {"blocks": {k: w[lo:hi]
                               for k, w in params["blocks"].items()}}
            if lo == 0:
                part["embed"] = params["embed"]
            if hi == L:
                part["lm_head"] = params["lm_head"]
                part["final_norm"] = params["final_norm"]
            staged.append(shard_params(self.cfg, part, self.t,
                                       m.group.local_ranks))
        return staged

    def cache_width(self, max_len: int) -> int:
        return next(m for m in self.stages if m).cache_width(max_len)

    def init_cache(self, batch: int, max_len: int):
        """Per stage, the per-rank ring caches [L_s, B, W, Hkv/t, D] (None
        for a stage another process runs)."""
        w = self.cache_width(max_len)
        return [m and m._rank_caches((hi - lo, batch, w), self.device)
                for m, (lo, hi) in zip(self.stages, self.ranges)]

    def init_paged_cache(self, num_pages: int, page_size: int):
        """Per stage, the per-rank page pools [L_s, P, ps, Hkv/t, D]; one
        block table addresses every stage's pool."""
        if self.cfg.sliding_window:
            raise ValueError(
                "paged KV cache keeps every position (pages, no ring wrap); "
                f"{self.cfg.name} uses a sliding window — serve it "
                "contiguous")
        return [m and m._rank_caches((hi - lo, num_pages, page_size),
                                     self.device)
                for m, (lo, hi) in zip(self.stages, self.ranges)]

    # ---------------------------------------------------------- boundary
    def _receive_buffers(self, s: int, shape, dtype, shard: int = 0):
        """Stage s + 1's buffers for the pair off stage s: two lists of one
        [..., h/t] tensor per local rank, allocated once per shape."""
        key = (s, tuple(shape), dtype, shard)
        if key not in self._recv:
            ranks = self.stages[s + 1].group.local_ranks
            self._recv[key] = tuple(
                [torch.empty(shape, dtype=dtype, device=self.device)
                 for _ in ranks] for _ in range(2))
        return self._recv[key]

    @torch.inference_mode()
    def send_boundary(self, out, s: int, rows, phase: str = "decode",
                      sharded: bool = False):
        """Ship stage s's carried pair (h, x) to stage s + 1: each rank's
        h/t slice of both tensors copied into the next stage's receive
        buffers, one ``TransferRecord`` per tensor.  Returns the received
        pair as two lists of t rank slices.  ``rows`` is the pass's
        (B, S), the shape a real stage receives into (``rows_of``).  A CP
        prefill (``sharded``; ``rows`` then (B, S/c)) ships the list of
        the local workers' pairs: every worker ships its own slices, the
        records are one worker's, [B, S/c, h/t], and the list of the
        received pairs is returned."""
        if self.place is not None:
            return self._ship_ranks(out, s, rows, phase, sharded)
        if sharded:
            return [self._ship(pair, s, phase, i) for i, pair in
                    enumerate(out)]
        return self._ship(out, s, phase)

    def _ship_ranks(self, out, s: int, rows, phase: str, sharded: bool):
        """The hop off stage s on real ranks: stage s's process sends its
        rank's two h/t slices (of its CP worker's shard, ``sharded``) to
        its peer on stage s + 1 and logs them (returns None); stage
        s + 1's process receives them into its buffers (returns them, a
        list of the one pair when ``sharded``); any other process does
        nothing."""
        place = self.place
        k = self.cfg.d_model // self.t
        if place.stage == s:
            h, x = out[0] if sharded else out
            if isinstance(h, GatheredSum):
                h = h.dequantize(x.dtype)
            r = place.group.rank
            pieces = [full[..., r * k:(r + 1) * k].contiguous()
                      for full in (h, x)]
            for req in dist.batch_isend_irecv(
                    [dist.P2POp(dist.isend, piece, place.next)
                     for piece in pieces]):
                req.wait()
            for piece in pieces:
                self.transfers.append(TransferRecord(
                    phase, 1, tuple(piece.shape), piece.element_size()))
            return None
        if place.stage == s + 1:
            bufs = self._receive_buffers(s, (*rows, k),
                                         torch_dtype(self.cfg.dtype))
            for req in dist.batch_isend_irecv(
                    [dist.P2POp(dist.irecv, ranks[0], place.prev)
                     for ranks in bufs]):
                req.wait()
            return [bufs] if sharded else bufs
        return None

    def _ship(self, out, s: int, phase: str, shard: int = 0):
        h, x = out
        if isinstance(h, GatheredSum):
            h = h.dequantize(x.dtype)
        k = self.cfg.d_model // self.t
        bufs = self._receive_buffers(s, (*x.shape[:-1], k), x.dtype, shard)
        for full, ranks in zip((h, x), bufs):
            for r, buf in enumerate(ranks):
                buf.copy_(full[..., r * k:(r + 1) * k])
            if shard == 0:
                self.transfers.append(TransferRecord(
                    phase, 1, tuple(ranks[0].shape), x.element_size()))
        return bufs

    def feed_tokens(self, tokens):
        """Next-token ids onto the device: the feedback hop that starts a
        decode round (a few bytes, not charged by Eq. 2)."""
        return torch.as_tensor(tokens, dtype=torch.int32,
                               device=self.device)

    @staticmethod
    def rows_of(x):
        """(B, S) of a pass's fed token ids [B, S] (S = 1 for [B])."""
        return (x.shape[0], x.shape[1] if x.dim() > 1 else 1)

    def next_token(self, logits, batch: int):
        """The greedy token [batch] int32 of the last stage's logits, on
        every rank: on real ranks the last stage's argmax, broadcast from
        its first rank (B int32 a step, outside Eq. 2; ``logits`` is None
        on the other stages)."""
        if self.place is None:
            return greedy_tokens(logits)
        if logits is not None:
            tok = greedy_tokens(logits)
        else:
            tok = torch.empty(batch, dtype=torch.int32, device=self.device)
        dist.broadcast(tok, src=self.place.last_rank)
        return tok

    def _head_out(self, out):
        """A pass's result: the last stage's logits (None on a process
        that does not run the last stage)."""
        return out if self.stages[-1] is not None else None

    # ------------------------------------------------------- stage passes
    def decode_stage_fns(self):
        """Per stage fn(params, cache, x, pos) -> (out, cache): one decode
        step of the stage, drivable on its own by the instruction queue
        (None for a stage another process runs)."""
        return [m and functools.partial(m.stage_decode, lo=lo, hi=hi)
                for m, (lo, hi) in zip(self.stages, self.ranges)]

    def paged_stage_fns(self):
        """Per stage fn(params, cache, x, pos, block_table) -> (out, cache):
        one paged pass of the stage (a chunk or a decode step; None for a
        stage another process runs)."""
        return [m and functools.partial(m.stage_paged, lo=lo, hi=hi)
                for m, (lo, hi) in zip(self.stages, self.ranges)]

    # ------------------------------------------------------------ passes
    def _prefill(self, staged, tokens, cache_w, phase: str, last=None):
        check_cp_tokens(tokens, self.c)
        x = self.feed_tokens(tokens)
        (B, S), caches, out = self.rows_of(x), [], None
        rows, sharded = (B, S // self.c), self.c > 1
        for s, (m, (lo, hi)) in enumerate(zip(self.stages, self.ranges)):
            cache = None
            if m is not None:
                out, cache = m.stage_prefill(staged[s], x, lo, hi, cache_w,
                                             last)
            caches.append(cache)
            if s < self.p - 1:
                x = self.send_boundary(out, s, rows, phase, sharded)
        return self._head_out(out), caches

    def forward(self, staged, tokens, phase: str = "prefill",
                last: int = None):
        """One pass without caches; logs (p - 1)·2 transfers of
        [B, S, h/t] (Eq. 2 / Eq. 7; [B, S/c, h/t] at c > 1).  Returns the
        logits of position ``last`` (default the last; at c > 1, S a
        multiple of c)."""
        return self._prefill(staged, tokens, None, phase, last)[0]

    def prefill_with_cache(self, staged, tokens, cache_w: int,
                           last: int = None):
        """A prefill that builds every stage's ring caches of width
        ``cache_w``: (logits [B, v] of position ``last``, per-stage
        caches); at c > 1 the caches come from the assembled K/V."""
        return self._prefill(staged, tokens, cache_w, "prefill", last)

    def decode_once(self, staged, caches, token, pos):
        """One decode step through every stage: token [B], ``pos`` a
        scalar or [B]; each boundary ships the [B, 1, h/t] pair (the
        decode rows of Table V).  Returns (logits [B, v], caches), the
        caches updated in place."""
        x, out = self.feed_tokens(token), None
        rows = self.rows_of(x)
        for s, fn in enumerate(self.decode_stage_fns()):
            if fn is not None:
                out, caches[s] = fn(staged[s], caches[s], x, pos)
            if s < self.p - 1:
                x = self.send_boundary(out, s, rows, "decode")
        return self._head_out(out), caches

    def paged_pass(self, staged, caches, tokens, pos, bt,
                   phase: str = "decode"):
        """One paged pass through every stage: a prefill chunk (tokens
        [B, S], phase "prefill") or a decode step (tokens [B, 1]); the
        boundary hops are logged under ``phase``.  Returns (last-position
        logits [B, v], per-stage page pools, updated in place)."""
        x, out = self.feed_tokens(tokens), None
        rows = self.rows_of(x)
        for s, fn in enumerate(self.paged_stage_fns()):
            if fn is not None:
                out, caches[s] = fn(staged[s], caches[s], x, pos, bt)
            if s < self.p - 1:
                x = self.send_boundary(out, s, rows, phase)
        return self._head_out(out), caches

    def generate(self, staged, caches, token, pos, num_tokens: int):
        """Greedy generation of ``num_tokens`` through the pipeline:
        (tokens [B, num_tokens] int32, caches).  Logs (p - 1)·2·N decode
        transfers: with the prefill's token, the paper's (p-1)·2·(s_d-1)
        for s_d = N + 1."""
        token = self.feed_tokens(token)
        return greedy_decode_loop(
            lambda c, tok, p: self.decode_once(staged, c, tok, p),
            token, caches, pos, num_tokens,
            pick=lambda logits: self.next_token(logits, token.shape[0]))

    def transfer_summary(self, phase: str = None) -> dict:
        """The logged transfers (of one ``phase``): count and bytes."""
        recs = [r for r in self.transfers if phase in (None, r.phase)]
        return {"count": sum(r.count for r in recs),
                "bytes": sum(r.bytes for r in recs)}
