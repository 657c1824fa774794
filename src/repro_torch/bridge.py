"""Carry model weights between the JAX package and the port through numpy.

``params_from_jax`` takes the pytree of ``repro.models.transformer.
Model.init`` after conversion to numpy arrays (the caller converts it; this
module never imports JAX) and returns the port's parameter dict on a
device.  Both packages keep one layout — ``blocks`` stacked on a leading
[L, ...] axis, ``embed``, ``lm_head``, ``final_norm`` — so the bridge only
checks shapes and types and moves the arrays.  Every leaf keeps the type
the JAX pytree gives it: the model's type, or f32 for the ssm family's
``w0`` and ``u``, the moe family's ``router`` and the hybrid family's
``b_dt``, ``A_log`` and ``D``.  ``params_to_numpy`` is the inverse; a
round trip is bitwise, bfloat16 included.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import hybrid as hybrid_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import resolve_device


def _ssm_block_shapes(cfg: ModelConfig) -> dict:
    """The 22 block parameters of ``ssm.init_ssm_blocks``."""
    h, L, ff = cfg.d_model, cfg.num_layers, cfg.d_ff
    shapes = {name: (L, h) for name in (
        "ln1", "ln2", "mx_r", "mx_k", "mx_v", "mx_w", "mx_g", "w0", "ln_x",
        "cmx_k", "cmx_r")}
    shapes.update({name: (L, h, h)
                   for name in ("wr", "wk", "wv", "wg", "wo", "cwr")})
    shapes.update(wa=(L, h, ssm_lib.DECAY_LORA), wb=(L, ssm_lib.DECAY_LORA, h),
                  u=(L, cfg.num_heads, cfg.ssm.head_size), cwk=(L, h, ff),
                  cwv=(L, ff, h))
    return shapes


def _attention_shapes(cfg: ModelConfig, n_heads: int) -> dict:
    h, L, d = cfg.d_model, cfg.num_layers, cfg.head_dim
    return {"wq": (L, h, n_heads * d), "wk": (L, h, cfg.num_kv_heads * d),
            "wv": (L, h, cfg.num_kv_heads * d), "wo": (L, n_heads * d, h)}


def _mlp_shapes(cfg: ModelConfig, ff: int, prefix: str = "") -> dict:
    h, L = cfg.d_model, cfg.num_layers
    shapes = {"w1": (L, h, ff), "w2": (L, ff, h)}
    if cfg.activation in ("swiglu", "geglu"):
        shapes["w3"] = (L, h, ff)
    return {prefix + k: v for k, v in shapes.items()}


def _moe_block_shapes(cfg: ModelConfig) -> dict:
    """The block parameters of ``moe.init_moe_blocks``."""
    moe, h, L = cfg.moe, cfg.d_model, cfg.num_layers
    E, f = moe.num_experts, moe.expert_d_ff
    shapes = _attention_shapes(cfg, cfg.num_heads)
    shapes.update(router=(L, h, E), we1=(L, E, h, f), we2=(L, E, f, h),
                  we3=(L, E, h, f), ln1=(L, h), ln2=(L, h))
    if moe.num_shared_experts:
        shapes.update(_mlp_shapes(
            cfg, moe.shared_d_ff * moe.num_shared_experts, "s"))
    return shapes


def _hybrid_block_shapes(cfg: ModelConfig) -> dict:
    """The block parameters of ``hybrid.init_hybrid_blocks``."""
    h, L = cfg.d_model, cfg.num_layers
    n_attn, n_ssm = hybrid_lib.head_split(cfg)
    di, N = n_ssm * cfg.head_dim, cfg.ssm.state_size
    shapes = _attention_shapes(cfg, n_attn)
    shapes.update(_mlp_shapes(cfg, cfg.d_ff))
    shapes.update({name: (L, h) for name in ("ln1", "ln2", "ln_attn",
                                             "ln_ssm")})
    shapes.update(in_proj=(L, h, 2 * di), w_dt=(L, di, di), b_dt=(L, di),
                  w_B=(L, di, N), w_C=(L, di, N), A_log=(L, di, N),
                  D=(L, di), ssm_out=(L, di, h))
    return shapes


def expected_shapes(cfg: ModelConfig) -> dict:
    """Parameter name -> shape of a model of ``cfg`` (any family)."""
    h, L = cfg.d_model, cfg.num_layers
    pv = cfg.padded_vocab
    if cfg.family == "ssm":
        blocks = _ssm_block_shapes(cfg)
    elif cfg.family == "moe":
        blocks = _moe_block_shapes(cfg)
    elif cfg.family == "hybrid":
        blocks = _hybrid_block_shapes(cfg)
    else:
        blocks = _attention_shapes(cfg, cfg.num_heads)
        blocks.update(_mlp_shapes(cfg, cfg.d_ff), ln1=(L, h), ln2=(L, h))
    shapes = {"blocks": blocks, "final_norm": (h,)}
    if cfg.family != "encoder":         # the encoder takes frame embeddings
        shapes["embed"] = (pv, h)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (h, pv)
    return shapes


def expected_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """The type of block parameter (or top-level leaf) ``name``."""
    f32 = {"ssm": ssm_lib.F32_PARAMS, "moe": moe_lib.F32_PARAMS,
           "hybrid": hybrid_lib.F32_PARAMS}.get(cfg.family, ())
    return torch.float32 if name in f32 else torch_dtype(cfg.dtype)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16: move the bits and reinterpret
        t = torch.from_numpy(np.array(a).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # registers numpy's bfloat16 (the JAX arrays' type)
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(np_params: dict, cfg: ModelConfig, device=None) -> dict:
    """Port parameters from a numpy copy of the JAX ``Model.init`` pytree."""
    device = resolve_device(device)
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
        t = _to_torch(a)
        if t.dtype != expected_dtype(cfg, name):
            raise ValueError(f"{name}: {t.dtype} != "
                             f"{expected_dtype(cfg, name)}")
        return t.to(device)

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
