"""Inference engine of the port: batched prefill + greedy decode.

Counterpart of ``repro.runtime.engine.InferenceEngine``.  Decode runs
``decode_chunk`` steps per ``Model.decode_steps`` call and single steps for
the tail; the [L, B, W, Hkv, D] cache is updated in place for the whole
generation (the JAX engine donated it).  The output is identical for every
``decode_chunk``.  Replaying the chunk as a CUDA graph is a later step.
"""
from __future__ import annotations

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models.transformer import get_model, resolve_device


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
        if not cfg.is_decoder:
            raise ValueError(f"{cfg.name} is encoder-only: no decode")
        check_params_device(params, self.device)
        self.cfg = cfg
        self.model = get_model(cfg, plain)
        self.params = params
        self.max_len = max_len
        self.decode_chunk = max(int(decode_chunk), 1)

    @torch.inference_mode()
    def generate(self, tokens, max_new_tokens: int = 32) -> torch.Tensor:
        """tokens [B, S_p] -> generated [B, max_new_tokens] int32 (greedy)."""
        tokens = torch.as_tensor(tokens, dtype=torch.int32,
                                 device=self.device)
        logits, cache, _ = self.model.prefill(self.params, tokens,
                                              self.max_len)
        pos = tokens.shape[1]
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
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
            logits, cache = self.model.decode_step(self.params, cache, tok,
                                                   pos)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            pieces.append(tok[:, None])
            pos += 1
        return torch.cat(pieces, dim=1)
