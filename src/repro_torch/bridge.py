"""Carry model weights between the JAX package and the port through numpy.

``params_from_jax`` takes the pytree of ``repro.models.transformer.
Model.init`` after conversion to numpy arrays (the caller converts it; this
module never imports JAX) and returns the port's parameter dict on a
device.  Both packages keep one layout — ``blocks`` stacked on a leading
[L, ...] axis, ``embed``, ``lm_head``, ``final_norm`` — so the bridge only
checks shapes and moves the arrays.  ``params_to_numpy`` is the inverse;
a round trip is bitwise, bfloat16 included.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import resolve_device


def expected_shapes(cfg: ModelConfig) -> dict:
    """Parameter name -> shape of a dense model of ``cfg``."""
    h, L, d = cfg.d_model, cfg.num_layers, cfg.head_dim
    pv = cfg.padded_vocab
    blocks = {
        "wq": (L, h, cfg.num_heads * d), "wk": (L, h, cfg.num_kv_heads * d),
        "wv": (L, h, cfg.num_kv_heads * d), "wo": (L, cfg.num_heads * d, h),
        "w1": (L, h, cfg.d_ff), "w2": (L, cfg.d_ff, h),
        "ln1": (L, h), "ln2": (L, h)}
    if cfg.activation in ("swiglu", "geglu"):
        blocks["w3"] = (L, h, cfg.d_ff)
    shapes = {"blocks": blocks, "final_norm": (h,), "embed": (pv, h)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (h, pv)
    return shapes


def _to_torch(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16: move the bits and reinterpret
        t = torch.from_numpy(np.array(a).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # registers numpy's bfloat16 (the JAX arrays' type)
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(np_params: dict, cfg: ModelConfig, device=None) -> dict:
    """Port parameters from a numpy copy of the JAX ``Model.init`` pytree."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    shapes = expected_shapes(cfg)
    if set(np_params) != set(shapes):
        raise ValueError(f"parameter keys {sorted(np_params)} != "
                         f"{sorted(shapes)} for {cfg.name}")
    if set(np_params["blocks"]) != set(shapes["blocks"]):
        raise ValueError(f"block keys {sorted(np_params['blocks'])} != "
                         f"{sorted(shapes['blocks'])}")

    def convert(a, shape, name):
        if tuple(np.shape(a)) != shape:
            raise ValueError(f"{name}: shape {np.shape(a)} != {shape}")
        return _to_torch(a, dtype, device)

    out = {key: convert(np_params[key], shape, key)
           for key, shape in shapes.items() if key != "blocks"}
    out["blocks"] = {key: convert(np_params["blocks"][key], shape, key)
                     for key, shape in shapes["blocks"].items()}
    return out


def params_to_numpy(params: dict) -> dict:
    """numpy copy of port parameters, in the JAX pytree's layout."""
    return {key: ({k: _to_numpy(v) for k, v in val.items()}
                  if isinstance(val, dict) else _to_numpy(val))
            for key, val in params.items()}
