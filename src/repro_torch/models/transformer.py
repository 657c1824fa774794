"""Model trunk of the port: embedding, a loop over stacked blocks, final
norm and head.

Counterpart of ``repro.models.transformer`` for all six families: dense,
encoder (hubert: frame embeddings in, the bidirectional mask, no
decode), vlm (paligemma: image-prefix embeddings before the tokens, the
prefix mask), moe, ssm (RWKV-6) and hybrid (hymba); the block and its
init are picked by ``cfg.family``, as the JAX package's ``_BLOCKS`` does.
Parameters keep the JAX package's layout — a dict with ``blocks`` stacked
on a leading [L, ...] axis, ``embed`` [V_pad, h] (none for the encoder),
``lm_head`` [h, V_pad] and ``final_norm`` [h] — so ``repro_torch.bridge``
carries JAX weights over unchanged.  The layer loop is a Python loop (the
JAX package scanned it), and caches are updated in place (the JAX package
donated them).  The loop carries the residual stream as a pair (h, x), so
every residual add runs inside the norm after it (``blocks`` module doc);
the values are the JAX package's chain, add then norm.  With a
``DeviceMesh`` set in ``runtime.meshctx``, every family runs each entry
point below but ``paged_step`` as one sharded step on DTensors
(``runtime.sharding``): the vocab-parallel embedding and head, the
blocks' sites (the attention and MLP of ``blocks``, the routed experts
of ``moe``, RWKV-6's time and channel mixes of ``ssm``, hymba's mamba
branch of ``hybrid``), the logits left vocab-sharded and
``greedy_tokens``' argmax over them.

Entry points:
  forward(params, tokens, prefix_emb=None, features=None, remat=None,
          return_hidden=False)
                                         full-sequence logits + aux loss
                                         (the encoder takes ``features``;
                                         the trainer's pass, with remat
                                         and the final hidden states)
  prefill(params, tokens, max_len, prefix_emb=None)
                                         last-position logits + cache (a
                                         ring KV cache, the ssm state, or
                                         both for the hybrid family)
  decode_step(params, cache, tokens, pos) one token against the cache
  decode_steps(..., num_tokens)          greedy multi-token decode
  paged_step(params, cache, tokens, pos, block_table)
                                         a prefill chunk or a decode step
                                         against KV pages (dense only)
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils import checkpoint as checkpoint_lib

from repro_torch.config.base import ModelConfig
from repro_torch.models import blocks as blocks_lib
from repro_torch.models import hybrid as hybrid_lib
from repro_torch.models import layers as layers_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import add_norm, dense_init, torch_dtype
from repro_torch.runtime import meshctx
from repro_torch.runtime import sharding as sh

_BLOCKS = {
    "dense": (blocks_lib.init_dense_blocks, blocks_lib.dense_block_apply),
    "encoder": (blocks_lib.init_dense_blocks, blocks_lib.dense_block_apply),
    "vlm": (blocks_lib.init_dense_blocks, blocks_lib.dense_block_apply),
    "moe": (moe_lib.init_moe_blocks, moe_lib.moe_block_apply),
    "ssm": (ssm_lib.init_ssm_blocks, ssm_lib.ssm_block_apply),
    "hybrid": (hybrid_lib.init_hybrid_blocks, hybrid_lib.hybrid_block_apply),
}


# the matrix products ``remat="dots"`` keeps (JAX's checkpoint_dots)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return checkpoint_lib.CheckpointPolicy.MUST_SAVE
    return checkpoint_lib.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_kwargs(remat: str) -> dict:
    """``torch.utils.checkpoint.checkpoint`` arguments of a layer under
    ``remat``: None for "none"; "full" recomputes the whole layer in the
    backward; "dots" saves the outputs of the matrix products and
    recomputes the rest (the JAX trunk's ``jax.checkpoint`` policies)."""
    if remat == "none":
        return None
    kw = {"use_reentrant": False}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            checkpoint_lib.create_selective_checkpoint_contexts, _save_dots)
    elif remat != "full":
        raise ValueError(f"remat {remat!r} not in ('none', 'full', 'dots')")
    return kw


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    asks for another; raises when no card is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card — pass device='cpu' "
            "to run its plain versions on the CPU")
    return device


def greedy_tokens(logits):
    """The greedy token [B] int32 of logits [B, v].  Under a DeviceMesh
    the logits are vocab-sharded DTensors, and the argmax is JAX's
    compiled one: each rank's max and its (global) index, both
    all-gathered over "model", the first of the largest kept."""
    if meshctx.get_device_mesh() is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    r = sh.model_rank()

    def local(lg):
        idx = torch.argmax(lg, dim=-1, keepdim=True)
        val = torch.gather(lg, -1, idx)
        vals = sh.gather_model_values(val, -1)                   # [b, m]
        idxs = sh.gather_model_values(
            (idx + r * lg.shape[-1]).to(torch.int32), -1)
        best = torch.argmax(vals, dim=-1, keepdim=True)
        return torch.gather(idxs, -1, best)[..., 0]

    return sh.local_site(local, sh.replicate_model(logits.placements),
                         logits)


def greedy_decode_loop(step_fn, tokens, cache, pos, num_tokens: int,
                       pick=None):
    """``num_tokens`` greedy steps feeding each argmax back in at the next
    position (the JAX package's fori_loop as a Python loop).
    ``step_fn(cache, tok [B], pos_i) -> (logits [B, v], cache)``; ``pick``
    (default ``greedy_tokens``) makes the next tokens of the logits.
    Returns (generated [B, num_tokens] int32, cache)."""
    pick = greedy_tokens if pick is None else pick
    out = []
    tok = tokens
    for i in range(num_tokens):
        logits, cache = step_fn(cache, tok, pos + i)
        tok = pick(logits)
        out.append(tok)
    return torch.stack(out, dim=1), cache


class Model:
    """Functional model for one ModelConfig of a ported family.

    ``plain=True`` runs the plain versions of the kernels (the JAX
    package's attention, RMSNorm and WKV recurrence): the path the
    kernels are held to."""

    def __init__(self, cfg: ModelConfig, plain: bool = False):
        self.cfg = cfg
        self.plain = bool(plain)
        self._init_blocks, self._block_apply = _BLOCKS[cfg.family]

    # ------------------------------------------------------------- params
    def init(self, seed: int = 0, device=None) -> dict:
        """Seeded random weights, made on ``device`` by the JAX package's
        rule (normal / sqrt(fan_in); embedding scale 1; zero norms; pad
        vocab rows and columns zeroed).  The draws differ from JAX's, which
        ``repro_torch.bridge`` carries over when equal weights are needed."""
        cfg = self.cfg
        device = resolve_device(device)
        dtype = torch_dtype(cfg.dtype)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        params = {
            "blocks": self._init_blocks(gen, cfg, cfg.num_layers, dtype),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                      device=device),
        }
        pv = cfg.padded_vocab
        if cfg.family != "encoder":     # the encoder takes frame embeddings
            emb = dense_init(gen, (pv, cfg.d_model), dtype, scale=1.0)
            emb[cfg.vocab_size:] = 0
            params["embed"] = emb
        if not cfg.tie_embeddings:
            head = dense_init(gen, (cfg.d_model, pv), dtype)
            head[:, cfg.vocab_size:] = 0
            params["lm_head"] = head
        return params

    # ------------------------------------------------------------ helpers
    def _embed(self, params, tokens, prefix_emb=None, features=None):
        """[B, S, h] inputs of the first layer: the encoder's ``features``
        in the model's type; otherwise the token embeddings (times sqrt(h)
        where the config scales them), after ``prefix_emb`` [B, P, h] when
        given."""
        cfg = self.cfg
        if cfg.family == "encoder":
            return features.to(torch_dtype(cfg.dtype))
        if meshctx.get_device_mesh() is not None:
            return self._embed_sharded(params["embed"], tokens, prefix_emb)
        x = params["embed"][tokens.long()]
        if cfg.scale_embedding:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
        if prefix_emb is not None:
            x = torch.cat([prefix_emb.to(x.dtype), x], dim=1)
        return x

    def _embed_sharded(self, embed, tokens, prefix_emb):
        """The vocab-parallel lookup of a sharded step: each rank looks up
        the tokens in its vocab rows, zeroes the rest, and one all-reduce
        over "model" sums them (then the scale and the prefix, as
        ``_embed``)."""
        cfg = self.cfg
        r = sh.model_rank()
        scale = math.sqrt(cfg.d_model) if cfg.scale_embedding else None
        tied = self._tied_reduce(tokens)

        def local(emb, tokens, *prefix):
            if tied:
                emb = sh.reduce_batch_grad(emb)
            n = emb.shape[0]
            ids = tokens.long() - r * n
            ok = (ids >= 0) & (ids < n)
            x = emb[torch.where(ok, ids, 0)]
            x = sh.reduce_model(torch.where(ok[..., None], x,
                                            x.new_zeros(())))
            if scale is not None:
                x = x * torch.tensor(scale, dtype=x.dtype)
            if prefix:
                x = torch.cat([prefix[0].to(x.dtype), x], dim=1)
            return x

        args = (embed, tokens) + (() if prefix_emb is None else
                                  (prefix_emb,))
        return sh.local_site(local, tokens.placements, *args,
                             weights=() if tied else (0,))

    def _tied_reduce(self, x) -> bool:
        """Whether each use of the tied embedding sums its own gradient
        over the batch axes (a sharded step's batch split over them)."""
        return (self.cfg.tie_embeddings and self.cfg.family != "encoder"
                and sh.batch_sharded(x))

    def _place_inputs(self, *inputs):
        """Plain inputs of a sharded step as DTensors, their batch dim over
        the batch axes where it divides them (``sharding.data_spec``)."""
        dmesh = meshctx.get_device_mesh()
        if dmesh is None:
            return inputs
        out = []
        for t in inputs:
            if t is not None and not sh.is_dtensor(t):
                t = sh.place(t, sh.P(sh.batch_entry(dmesh, t.shape[0]),
                                     *([None] * (t.dim() - 1))))
            out.append(t)
        return out

    def _positions(self, x):
        """Positions [B, S] of a full-sequence pass over x [B, S, h]."""
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        return self._place_inputs(positions)[0]

    def _prefix_kw(self, prefix_emb) -> dict:
        """The block's ``prefix_len`` where the family's mask takes one."""
        if prefix_emb is None or self.cfg.family != "vlm":
            return {}
        return {"prefix_len": prefix_emb.shape[1]}

    def _head(self, params, carried, last: bool = True):
        """Logits [B, v] of the last position ([B, S, v] of every position
        when ``last`` is False).  ``carried`` is the trunk's (h, x) after
        the last layer: the final norm runs the last layer's closing
        residual add."""
        cfg = self.cfg
        x = self._final_norm(params, carried, last)
        if meshctx.get_device_mesh() is not None:
            return self._head_sharded(params, x)
        if cfg.tie_embeddings and cfg.family != "encoder":
            logits = x @ params["embed"].T
        else:
            logits = x @ params["lm_head"]
        if cfg.padded_vocab != cfg.vocab_size:
            # mask at the logits' own dtype minimum
            col = torch.arange(cfg.padded_vocab, device=logits.device)
            logits = torch.where(col < cfg.vocab_size, logits,
                                 torch.finfo(logits.dtype).min)
        return logits

    def _head_sharded(self, params, xn):
        """The vocab-parallel head of a sharded step: each rank's logits of
        its vocab columns (the tied head is its ``embed`` rows), the pad
        columns masked; the logits stay sharded over "model", no gather."""
        cfg = self.cfg
        tied = cfg.tie_embeddings and cfg.family != "encoder"
        head = params["embed"] if tied else params["lm_head"]
        r = sh.model_rank()
        reduce = self._tied_reduce(xn)

        def local(xn, w):
            if reduce:
                w = sh.reduce_batch_grad(w)
            logits = sh.copy_to_model(xn) @ (w.T if tied else w)
            if cfg.padded_vocab != cfg.vocab_size:
                n = logits.shape[-1]
                col = r * n + torch.arange(n, device=logits.device)
                logits = torch.where(col < cfg.vocab_size, logits,
                                     torch.finfo(logits.dtype).min)
            return logits

        from torch.distributed.tensor import Shard
        return sh.local_site(local, sh.with_model(xn.placements,
                                                  Shard(xn.dim() - 1)),
                             xn, head, weights=() if reduce else (1,))

    def _final_norm(self, params, carried, last: bool):
        """The final norm of the last position ([B, h]; [B, S, h] of every
        position when ``last`` is False), closing the last layer's
        residual add (on a sharded step its all-reduce runs over every
        position first, as XLA's)."""
        h, x = carried
        if h is not None and meshctx.get_device_mesh() is not None:
            h = sh.reduce_branch(h)
        if last:
            x, h = x[:, -1], None if h is None else h[:, -1]
        return add_norm(x, h, params["final_norm"], self.cfg.norm_eps,
                        self.plain)[1]

    def head_matrix(self, params):
        """The [h, V_pad] output projection (tied or untied)."""
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def cache_width(self, max_len: int) -> int:
        w = self.cfg.sliding_window or max_len
        return min(w, max_len)

    def _layer(self, params, l):
        return {name: w[l] for name, w in params["blocks"].items()}

    def _block(self, p_l, x, positions, **kw):
        """One layer on the carried pair (h, x) (``blocks`` module doc)."""
        return self._block_apply(self.cfg, p_l, x, positions,
                                 plain=self.plain, carry=True, **kw)

    # ---------------------------------------------------------- interface
    def _trunk_layer(self, p_l, positions, kw, h, x):
        """One layer (its weights ``p_l``) of a full-sequence pass on the
        carried pair (h, x) -> (h, x, the layer's MoE aux loss or None)."""
        auxes = []
        if self.cfg.family == "moe":
            kw = {"aux_out": auxes}
        (h, x), _ = self._block(p_l, (h, x), positions, **kw)
        return h, x, (auxes[0] if auxes else None)

    def forward(self, params, tokens=None, prefix_emb=None, features=None,
                remat=None, return_hidden: bool = False):
        """tokens [B, S] (the vlm's after ``prefix_emb`` [B, P, h]; the
        encoder takes ``features`` [B, S, h] instead) -> (logits
        [B, P + S, v], aux): the full-sequence pass in the family's mask
        (causal, bidirectional for the encoder, the prefix mask over the P
        prefix positions for the vlm; with the window where the config
        has one) and no cache.  ``aux`` is the MoE router's auxiliary loss
        summed over the layers (f32; 0 for the other families).

        ``remat`` ("none", "full" or "dots"; default ``cfg.remat``)
        checkpoints each layer for the backward (``_remat_kwargs``): the
        kernels of a recomputed layer launch again there.
        ``return_hidden`` returns the final norm's output [B, P + S, h] of
        every position in place of the logits (the fused loss projects it
        a vocab chunk at a time).

        Under a DeviceMesh (``runtime.meshctx``) every family runs as one
        sharded step on DTensors (module doc, ``runtime.sharding``); the
        logits come out vocab-sharded, and the MoE aux loss is the global
        batch's."""
        tokens, prefix_emb, features = self._place_inputs(
            tokens, prefix_emb, features)
        x = self._embed(params, tokens, prefix_emb, features)
        positions = self._positions(x)
        remat = _remat_kwargs(self.cfg.remat if remat is None else remat)
        kw = self._prefix_kw(prefix_emb)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = None
        # the layers' weights as one unbind of each stacked leaf: its
        # backward stacks the L slices' gradients once, where indexing
        # w[l] would add each into a new zero-filled [L, ...] gradient
        names = list(params["blocks"])
        per_layer = zip(*(params["blocks"][n].unbind(0) for n in names))
        for weights in per_layer:
            layer = functools.partial(self._trunk_layer,
                                      dict(zip(names, weights)), positions,
                                      kw)
            if remat is None:
                h, x, a = layer(h, x)
            else:
                h, x, a = checkpoint_lib.checkpoint(layer, h, x, **remat)
            if a is not None:
                aux = aux + a
        if return_hidden:
            return self._final_norm(params, (h, x), last=False), aux
        return self._head(params, (h, x), last=False), aux

    def prefill(self, params, tokens, max_len: int, prefix_emb=None):
        """tokens [B, S] (after ``prefix_emb`` [B, P, h] for the vlm) ->
        (last-position logits [B, v], cache, P + S).  The cache is the ring
        KV cache {k, v: [L, B, W, Hkv, D]} (dense, vlm, moe), the recurrent
        state {state [L, B, H, hs, hs] f32, tm_prev, cm_prev [L, B, h]}
        (ssm), or the ring KV cache and the selective scan's state {k, v,
        ssm_state [L, B, di, N] f32} (hybrid)."""
        tokens, prefix_emb = self._place_inputs(tokens, prefix_emb)
        cfg = self.cfg
        L = cfg.num_layers
        x = self._embed(params, tokens, prefix_emb)
        S = x.shape[1]
        positions = self._positions(x)
        w = self.cache_width(max_len)
        kw = self._prefix_kw(prefix_emb)
        cache = None
        per_layer = []
        x = (None, x)
        for l in range(L):
            x, c = self._block(self._layer(params, l), x, positions,
                               build_cache_w=w, **kw)
            if meshctx.get_device_mesh() is not None:
                per_layer.append(c)
                continue
            if cache is None:
                cache = {key: val.new_empty((L, *val.shape))
                         for key, val in c.items()}
            for key, val in c.items():
                cache[key][l] = val
        if per_layer:
            cache = {key: sh.stack([c[key] for c in per_layer])
                     for key in per_layer[0]}
        return self._head(params, x), cache, S

    def init_cache(self, batch: int, max_len: int, device=None):
        """An empty cache for ``batch`` sequences: the ring KV cache
        (dense, moe), the ssm state, whose size does not depend on
        ``max_len``, or both (hybrid)."""
        cfg = self.cfg
        device = resolve_device(device)
        if cfg.family == "ssm":
            return ssm_lib.init_ssm_cache(cfg, cfg.num_layers, batch,
                                          torch_dtype(cfg.dtype), device)
        w = self.cache_width(max_len)
        if cfg.family == "hybrid":
            return hybrid_lib.init_hybrid_cache(cfg, cfg.num_layers, batch,
                                                w, torch_dtype(cfg.dtype),
                                                device)
        shape = (cfg.num_layers, batch, w, cfg.num_kv_heads, cfg.head_dim)
        return {key: torch.zeros(shape, dtype=torch_dtype(cfg.dtype),
                                 device=device) for key in ("k", "v")}

    def init_paged_cache(self, num_pages: int, page_size: int, device=None):
        """[L, P, ps, Hkv, D] K/V page pools (dense attention only; page 0
        is the scratch page — runtime/kvpool.py)."""
        cfg = self.cfg
        if cfg.family != "dense":
            raise ValueError(
                f"paged KV cache covers dense attention; {cfg.name} is "
                f"{cfg.family}")
        if cfg.sliding_window:
            raise ValueError(
                "paged KV cache keeps every position (pages, no ring wrap); "
                f"{cfg.name} uses a sliding window — serve it contiguous")
        device = resolve_device(device)
        shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
                 cfg.head_dim)
        return {key: torch.zeros(shape, dtype=torch_dtype(cfg.dtype),
                                 device=device) for key in ("k", "v")}

    def paged_step(self, params, cache, tokens, pos, block_table):
        """One paged pass: a prefill chunk (S > 1) or a decode step
        (S == 1).  tokens [B, S]; pos [B] start positions; block_table
        [B, n].  K/V rows of positions pos..pos+S-1 are written into their
        pages in place.  Returns (last-position logits [B, v], cache)."""
        x = self._embed(params, tokens)
        S = x.shape[1]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
        block_table = torch.as_tensor(block_table, dtype=torch.int32,
                                      device=x.device)
        positions = pos[:, None].long() + torch.arange(S, device=x.device)
        x = (None, x)
        for l in range(self.cfg.num_layers):
            layer_cache = {key: cache[key][l] for key in ("k", "v")}
            x, _ = self._block(self._layer(params, l), x, positions,
                               cache=layer_cache, pos=pos,
                               block_table=block_table)
        return self._head(params, x), cache

    def decode_step(self, params, cache, tokens, pos):
        """One step: tokens [B]; ``pos`` a scalar (every sequence at one
        depth) or [B] per-sequence positions (the ssm family ignores it).
        Returns (logits [B, v], cache), the cache updated in place."""
        tokens, = self._place_inputs(tokens)
        x = self._embed(params, tokens[:, None])
        B = x.shape[0]
        if sh.is_dtensor(pos):
            pos = pos.to_local()
        pos = torch.as_tensor(pos, device=x.device)
        if pos.dim() and meshctx.get_device_mesh() is not None:
            raise NotImplementedError(
                "a sharded decode step takes one position for the batch")
        positions = self._place_inputs(
            layers_lib.decode_positions(pos, B, device=x.device))[0]
        x = (None, x)
        for l in range(self.cfg.num_layers):
            layer_cache = {key: val[l] for key, val in cache.items()}
            x, _ = self._block(self._layer(params, l), x, positions,
                               cache=layer_cache, pos=pos)
        return self._head(params, x), cache

    def decode_steps(self, params, cache, tokens, pos, num_tokens: int):
        """Greedy multi-token decode (see ``greedy_decode_loop``)."""
        return greedy_decode_loop(
            lambda c, tok, p: self.decode_step(params, c, tok, p),
            tokens, cache, pos, num_tokens)


@functools.lru_cache(maxsize=None)
def _cached_model(cfg: ModelConfig, plain: bool) -> Model:
    return Model(cfg, plain)


def get_model(cfg: ModelConfig, plain: bool = False) -> Model:
    return _cached_model(cfg, bool(plain))

