"""Model trunk of the port: embedding, a loop over stacked dense blocks,
final norm and head.

Counterpart of ``repro.models.transformer`` for the dense family (the
other families are ROADMAP item A11).  Parameters keep the JAX package's
layout — a dict with ``blocks`` stacked on a leading [L, ...] axis,
``embed`` [V_pad, h], ``lm_head`` [h, V_pad] and ``final_norm`` [h] — so
``repro_torch.bridge`` carries JAX weights over unchanged.  The layer loop
is a Python loop (the JAX package scanned it), and KV caches are updated
in place (the JAX package donated them).

Entry points:
  prefill(params, tokens, max_len)       last-position logits + ring cache
  decode_step(params, cache, tokens, pos) one token against the ring cache
  decode_steps(..., num_tokens)          greedy multi-token decode
  paged_step(params, cache, tokens, pos, block_table)
                                         a prefill chunk or a decode step
                                         against KV pages
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.rmsnorm.ref import rms_norm_ref
from repro_torch.models import blocks as blocks_lib
from repro_torch.models import layers as layers_lib
from repro_torch.models.layers import dense_init, rms_norm, torch_dtype

PORTED_FAMILIES = ("dense",)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    asks for another; raises when no card is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card — pass device='cpu' "
            "to run its plain versions on the CPU")
    return device


def greedy_decode_loop(step_fn, tokens, cache, pos, num_tokens: int):
    """``num_tokens`` greedy steps feeding each argmax back in at the next
    position (the JAX package's fori_loop as a Python loop).
    ``step_fn(cache, tok [B], pos_i) -> (logits [B, v], cache)``.
    Returns (generated [B, num_tokens] int32, cache)."""
    out = []
    tok = tokens
    for i in range(num_tokens):
        logits, cache = step_fn(cache, tok, pos + i)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1), cache


class Model:
    """Functional dense model for one ModelConfig.

    ``plain=True`` runs the JAX package's plain attention and RMSNorm in
    place of the kernels (the path the kernels are held to)."""

    def __init__(self, cfg: ModelConfig, plain: bool = False):
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name} is {cfg.family}: the port covers the dense "
                "family; the other families are ROADMAP item A11")
        self.cfg = cfg
        self.plain = bool(plain)
        self._norm = rms_norm_ref if plain else rms_norm

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
            "blocks": blocks_lib.init_dense_blocks(gen, cfg, cfg.num_layers,
                                                   dtype),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                      device=device),
        }
        pv = cfg.padded_vocab
        emb = dense_init(gen, (pv, cfg.d_model), dtype, scale=1.0)
        emb[cfg.vocab_size:] = 0
        params["embed"] = emb
        if not cfg.tie_embeddings:
            head = dense_init(gen, (cfg.d_model, pv), dtype)
            head[:, cfg.vocab_size:] = 0
            params["lm_head"] = head
        return params

    # ------------------------------------------------------------ helpers
    def _embed(self, params, tokens):
        x = params["embed"][tokens.long()]
        if self.cfg.scale_embedding:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype)
        return x

    def _head(self, params, x):
        cfg = self.cfg
        x = self._norm(x.contiguous(), params["final_norm"], cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = x @ params["embed"].T
        else:
            logits = x @ params["lm_head"]
        if cfg.padded_vocab != cfg.vocab_size:
            # mask at the logits' own dtype minimum
            col = torch.arange(cfg.padded_vocab, device=logits.device)
            logits = torch.where(col < cfg.vocab_size, logits,
                                 torch.finfo(logits.dtype).min)
        return logits

    def cache_width(self, max_len: int) -> int:
        w = self.cfg.sliding_window or max_len
        return min(w, max_len)

    def _layer(self, params, l):
        return {name: w[l] for name, w in params["blocks"].items()}

    def _block(self, p_l, x, positions, **kw):
        return blocks_lib.dense_block_apply(self.cfg, p_l, x, positions,
                                            plain=self.plain, **kw)

    # ---------------------------------------------------------- interface
    def prefill(self, params, tokens, max_len: int):
        """tokens [B, S] -> (last-position logits [B, v], ring cache
        {k, v: [L, B, W, Hkv, D]}, S)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        w = self.cache_width(max_len)
        shape = (cfg.num_layers, B, w, cfg.num_kv_heads, cfg.head_dim)
        cache = {key: x.new_zeros(shape) for key in ("k", "v")}
        for l in range(cfg.num_layers):
            x, c = self._block(self._layer(params, l), x, positions,
                               build_cache_w=w)
            cache["k"][l] = c["k"]
            cache["v"][l] = c["v"]
        return self._head(params, x[:, -1:, :])[:, 0], cache, S

    def init_cache(self, batch: int, max_len: int, device=None):
        cfg = self.cfg
        device = resolve_device(device)
        w = self.cache_width(max_len)
        shape = (cfg.num_layers, batch, w, cfg.num_kv_heads, cfg.head_dim)
        return {key: torch.zeros(shape, dtype=torch_dtype(cfg.dtype),
                                 device=device) for key in ("k", "v")}

    def init_paged_cache(self, num_pages: int, page_size: int, device=None):
        """[L, P, ps, Hkv, D] K/V page pools (page 0 is the scratch page —
        runtime/kvpool.py)."""
        cfg = self.cfg
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
        for l in range(self.cfg.num_layers):
            layer_cache = {key: cache[key][l] for key in ("k", "v")}
            x, _ = self._block(self._layer(params, l), x, positions,
                               cache=layer_cache, pos=pos,
                               block_table=block_table)
        return self._head(params, x[:, -1:, :])[:, 0], cache

    def decode_step(self, params, cache, tokens, pos):
        """One step: tokens [B]; ``pos`` a scalar (every sequence at one
        depth) or [B] per-sequence positions.  Returns (logits [B, v],
        cache), the cache updated in place."""
        x = self._embed(params, tokens[:, None])
        B = x.shape[0]
        pos = torch.as_tensor(pos, device=x.device)
        positions = layers_lib.decode_positions(pos, B, device=x.device)
        for l in range(self.cfg.num_layers):
            layer_cache = {key: cache[key][l] for key in ("k", "v")}
            x, _ = self._block(self._layer(params, l), x, positions,
                               cache=layer_cache, pos=pos)
        return self._head(params, x)[:, 0], cache

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

