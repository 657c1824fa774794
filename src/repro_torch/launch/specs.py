"""Meta-tensor stand-ins for every (architecture x shape) input.

Counterpart of ``repro.launch.specs``: what a step consumes, as ``meta``
tensors (shapes and types, no allocation, at full width), beside their
partition specs on a mesh (``runtime.sharding``).  The audio and vision
frontends are stubs, as in the JAX package: the encoder takes frame
embeddings and the vlm image-prefix embeddings of the right shape.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import bridge
from repro_torch.config.base import ModelConfig, ShapeConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import get_model
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.sharding import P

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Principled (arch x shape) skips, as the JAX package documents them
    (DESIGN.md §4)."""
    if shape.mode == "decode" and not cfg.is_decoder:
        return "encoder-only architecture: no decode phase"
    if shape.name == "long_500k":
        sub_quadratic = (cfg.family in ("ssm", "hybrid")
                         or cfg.sliding_window is not None)
        if not sub_quadratic:
            return ("pure full-attention arch: 524k dense KV not claimed by "
                    "the model card (needs SWA/block-sparse variant)")
    return None


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                mesh=None) -> Tuple[Dict, Dict]:
    """(meta tensors, specs) of a train or prefill batch; the specs are
    None without a mesh."""
    B, S = shape.global_batch, shape.seq_len
    d2 = sh.data_spec(mesh, B, 1) if mesh else None
    d3 = sh.data_spec(mesh, B, 2) if mesh else None
    dt = torch_dtype(cfg.dtype)
    if cfg.family == "encoder":
        return ({"features": _meta((B, S, cfg.d_model), dt),
                 "targets": _meta((B, S), torch.int32)},
                {"features": d3, "targets": d2})
    if cfg.family == "vlm":
        pfx = cfg.num_prefix_tokens
        return ({"tokens": _meta((B, max(S - pfx, 1)), torch.int32),
                 "prefix_emb": _meta((B, pfx, cfg.d_model), dt)},
                {"tokens": d2, "prefix_emb": d3})
    return {"tokens": _meta((B, S), torch.int32)}, {"tokens": d2}


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """((token [B], pos, cache), specs) of one decode step against a
    seq_len-deep cache (``Model.init_cache`` on meta); the specs, (token,
    pos, cache tree), are None without a mesh."""
    B, S = shape.global_batch, shape.seq_len
    cache = get_model(cfg).init_cache(B, S, device=META)
    tok, pos = _meta((B,), torch.int32), _meta((), torch.int32)
    if mesh is None:
        return (tok, pos, cache), None
    return (tok, pos, cache), (sh.data_spec(mesh, B, 0), P(),
                               sh.cache_specs(cfg, mesh, B)(cache))


def param_sds(cfg: ModelConfig, mesh=None):
    """(meta parameters in the port's layout, their specs), from the
    bridge's shapes and types; nothing is allocated."""
    shapes = bridge.expected_shapes(cfg)
    params = {k: _meta(v, bridge.expected_dtype(cfg, k))
              for k, v in shapes.items() if k != "blocks"}
    params["blocks"] = {k: _meta(v, bridge.expected_dtype(cfg, k))
                        for k, v in shapes["blocks"].items()}
    axis_size = mesh.shape.get("model") if mesh is not None else None
    return params, sh.param_specs(cfg, params, axis_size=axis_size)
