"""Inference engine of the port: batched prefill + greedy decode.

Counterpart of ``repro.runtime.engine``: ``make_serve_step`` (one greedy
token for every sequence of a batch, the unit a decode-shape cost walk
measures) and ``InferenceEngine``.  Decode runs
``decode_chunk`` steps per ``Model.decode_steps`` call and single steps for
the tail; the [L, B, W, Hkv, D] cache is updated in place for the whole
generation (the JAX engine donated it).  The output is identical for every
``decode_chunk``.  Replaying the chunk as a CUDA graph is a later step.
An encoder-only config builds an engine that encodes (``encode``) and
raises in ``generate``, as the JAX engine does.
"""
from __future__ import annotations

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models.transformer import (get_model, greedy_tokens,
                                           resolve_device)


def make_serve_step(model):
    """(params, cache, token [B], pos) -> (next_token [B] int32, cache):
    one decode step and its greedy token, the cache updated in place.

    Under a DeviceMesh (``runtime.meshctx``) the step is sharded, as JAX's
    jitted ``serve_step`` under a mesh: params, cache and token are
    DTensors placed by ``runtime.sharding``'s specs, the logits stay
    vocab-sharded, and the argmax is ``transformer.greedy_tokens``'."""

    def serve_step(params, cache, token, pos):
        logits, cache = model.decode_step(params, cache, token, pos)
        return greedy_tokens(logits), cache

    return serve_step


def check_params_device(params: dict, device: torch.device) -> None:
    """Raise unless every parameter lies on ``device``."""
    def leaves(tree):
        for val in tree.values():
            yield from (leaves(val) if isinstance(val, dict) else (val,))
    for t in leaves(params):
        if t.device.type != device.type or (
                device.index is not None and t.device != device):
            raise ValueError(f"parameters on {t.device}, engine on {device}")


class InferenceEngine:
    """Single-device serving loop with greedy sampling over a batch.

    ``device`` defaults to the CUDA card and raises without one unless
    ``device="cpu"`` is passed (the CPU runs the kernels' plain
    versions).  ``plain=True`` runs the JAX package's plain attention and
    RMSNorm in place of the kernels — the path they are held to."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 2048,
                 decode_chunk: int = 8, device=None, plain: bool = False):
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        self.cfg = cfg
        self.model = get_model(cfg, plain)
        self.params = params
        self.max_len = max_len
        self.decode_chunk = max(int(decode_chunk), 1)
        self._step = make_serve_step(self.model)

    @torch.inference_mode()
    def generate(self, tokens, max_new_tokens: int = 32,
                 prefix_emb=None) -> torch.Tensor:
        """tokens [B, S_p] (after ``prefix_emb`` [B, P, h], the vlm's image
        prefix) -> generated [B, max_new_tokens] int32 (greedy); decode
        starts at position P + S_p."""
        if not self.cfg.is_decoder:
            raise ValueError(f"{self.cfg.name} is encoder-only: no decode")
        tokens = torch.as_tensor(tokens, dtype=torch.int32,
                                 device=self.device)
        if prefix_emb is not None:
            prefix_emb = torch.as_tensor(prefix_emb, device=self.device)
        logits, cache, pos = self.model.prefill(self.params, tokens,
                                                self.max_len, prefix_emb)
        tok = greedy_tokens(logits)
        pieces = [tok[:, None]]
        remaining = max_new_tokens - 1
        while remaining >= self.decode_chunk > 1:
            chunk, cache = self.model.decode_steps(
                self.params, cache, tok, pos, self.decode_chunk)
            pieces.append(chunk)
            tok = chunk[:, -1]
            pos += self.decode_chunk
            remaining -= self.decode_chunk
        for _ in range(remaining):
            tok, cache = self._step(self.params, cache, tok, pos)
            pieces.append(tok[:, None])
            pos += 1
        return torch.cat(pieces, dim=1)

    @torch.inference_mode()
    def encode(self, features) -> torch.Tensor:
        """features [B, S, h] -> logits [B, S, v]: the full-sequence pass
        (``Model.forward(features=)``)."""
        features = torch.as_tensor(features, device=self.device)
        logits, _ = self.model.forward(self.params, features=features)
        return logits
