"""RWKV-6 (Finch) block of the port: token-shifted time-mix with
data-dependent decay and a squared-ReLU channel-mix [arXiv:2404.05892].

Counterpart of ``repro.models.ssm``.  The WKV recurrence goes through
kernel B10 on the card (``kernels.rwkv6_scan.wkv6``), ``ln1``/``ln2``
through B1; ``plain=True`` runs their plain versions, the path the
kernels are held to on the whole model.  The per-layer cache is the f32
recurrent state and the two token-shift registers, O(1) in the sequence
length; a decode step updates it in place (the JAX package returned a
new one).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.rwkv6_scan.chunked import wkv6_chunked
from repro_torch.kernels.rwkv6_scan.ops import wkv6
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref
from repro_torch.models import layers
from repro_torch.models.layers import dense_init

DECAY_LORA = 64
F32_PARAMS = ("w0", "u")     # kept in f32 whatever the model's type


def init_ssm_blocks(gen: torch.Generator, cfg: ModelConfig, L: int, dtype):
    """Seeded [L, ...] block weights by the JAX package's rule, drawn from
    ``gen`` on its device (the draws differ from JAX's)."""
    h, ff = cfg.d_model, cfg.d_ff
    H, hs = cfg.num_heads, cfg.ssm.head_size

    def full(value, dt=dtype):
        return torch.full((L, h), value, dtype=dt, device=gen.device)

    return {
        "ln1": full(0.0), "ln2": full(0.0),
        # time-mix lerp coefficients (one per projection)
        "mx_r": full(0.5), "mx_k": full(0.5), "mx_v": full(0.5),
        "mx_w": full(0.5), "mx_g": full(0.5),
        "wr": dense_init(gen, (L, h, h), dtype),
        "wk": dense_init(gen, (L, h, h), dtype),
        "wv": dense_init(gen, (L, h, h), dtype),
        "wg": dense_init(gen, (L, h, h), dtype),
        "wo": dense_init(gen, (L, h, h), dtype),
        # data-dependent decay: w_t = exp(-exp(w0 + tanh(x @ wa) @ wb))
        "w0": full(-2.0, torch.float32),
        "wa": dense_init(gen, (L, h, DECAY_LORA), dtype),
        "wb": dense_init(gen, (L, DECAY_LORA, h), dtype, scale=0.01),
        "u": dense_init(gen, (L, H, hs), torch.float32, scale=0.5),
        "ln_x": full(0.0),        # per-head output norm
        # channel-mix
        "cmx_k": full(0.5), "cmx_r": full(0.5),
        "cwk": dense_init(gen, (L, h, ff), dtype),
        "cwv": dense_init(gen, (L, ff, h), dtype),
        "cwr": dense_init(gen, (L, h, h), dtype),
    }


def _shift(x, prev):
    """Token shift: xs[t] = x[t-1], xs[0] = prev.  x [B,S,h], prev [B,h]."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _head_norm(y, weight, H, hs, eps):
    B, S = y.shape[:2]
    yh = y.reshape(B, S, H, hs).float()
    var = (yh * yh).mean(dim=-1, keepdim=True)
    yh = yh * torch.rsqrt(var + eps)
    return (yh.reshape(B, S, H * hs) * (1.0 + weight.float())).to(y.dtype)


def rwkv_time_mix(cfg: ModelConfig, p, x, prev_x, state, state_out=None,
                  plain: bool = False, scan=None):
    """x [B,S,h]; prev_x [B,h]; state [B,H,hs,hs] f32 -> (y, last_x,
    new_state).  The kernel path writes the new state into ``state_out``
    when one is given.  ``scan`` (``wkv6_ref``'s signature), when given,
    computes the recurrence in place of the model's own."""
    B, S, h = x.shape
    H, hs = cfg.num_heads, cfg.ssm.head_size
    xs = _shift(x, prev_x)

    def mix(m):
        return x + (xs - x) * m

    r = (mix(p["mx_r"]) @ p["wr"]).reshape(B, S, H, hs)
    k = (mix(p["mx_k"]) @ p["wk"]).reshape(B, S, H, hs)
    v = (mix(p["mx_v"]) @ p["wv"]).reshape(B, S, H, hs)
    g = F.silu(mix(p["mx_g"]) @ p["wg"])
    dw = p["w0"] + torch.tanh(mix(p["mx_w"]) @ p["wa"]) @ p["wb"]
    # the decay in f32, rounded to r's type before the scan, as in JAX
    w = torch.exp(-torch.exp(dw.float())).reshape(B, S, H, hs).to(r.dtype)

    if scan is not None:
        y, new_state = scan(r, k, v, w, p["u"], state)
    elif (cfg.ssm.scan_impl == "chunked" and S > 1
            and S % cfg.ssm.scan_chunk == 0):
        y, new_state = wkv6_chunked(r, k, v, w, p["u"], state,
                                    chunk=cfg.ssm.scan_chunk)
    elif plain:
        y, new_state = wkv6_ref(r, k, v, w, p["u"], state)
    else:
        y, new_state = wkv6(r, k, v, w, p["u"], state, state_out)
    y = _head_norm(y.reshape(B, S, h), p["ln_x"], H, hs, cfg.norm_eps)
    return (y * g) @ p["wo"], x[:, -1, :], new_state


def rwkv_channel_mix(cfg: ModelConfig, p, x, prev_x):
    xs = _shift(x, prev_x)
    xk = x + (xs - x) * p["cmx_k"]
    xr = x + (xs - x) * p["cmx_r"]
    k = torch.square(torch.relu(xk @ p["cwk"]))
    return torch.sigmoid(xr @ p["cwr"]) * (k @ p["cwv"]), x[:, -1, :]


def init_ssm_cache(cfg: ModelConfig, L: int, batch: int, dtype, device):
    H, hs, h = cfg.num_heads, cfg.ssm.head_size, cfg.d_model
    return {
        "state": torch.zeros((L, batch, H, hs, hs), dtype=torch.float32,
                             device=device),
        "tm_prev": torch.zeros((L, batch, h), dtype=dtype, device=device),
        "cm_prev": torch.zeros((L, batch, h), dtype=dtype, device=device),
    }


def ssm_block_apply(cfg: ModelConfig, p, x, positions, cache=None, pos=None,
                    build_cache_w=None, plain: bool = False, scan=None,
                    carry: bool = False):
    """One RWKV-6 layer.  ``positions`` and ``pos`` are unused (the block
    has no positional encoding), as in JAX.  With ``cache`` (one layer's
    {state, tm_prev, cm_prev}) the cache is updated in place and returned;
    with ``build_cache_w`` a new one is returned; else None.  ``carry``
    passes the residual stream as the pair (h, x) in and out, the residual
    adds fused into the norm sites, as ``blocks.dense_block_apply`` does."""
    h_in, x = x if carry else (None, x)
    B = x.shape[0]
    H, hs, h = cfg.num_heads, cfg.ssm.head_size, cfg.d_model
    if cache is None:
        state = x.new_zeros((B, H, hs, hs), dtype=torch.float32)
        tm_prev = x.new_zeros((B, h))
        cm_prev = x.new_zeros((B, h))
    else:
        state, tm_prev, cm_prev = (cache["state"], cache["tm_prev"],
                                   cache["cm_prev"])
    x, xn = layers.add_norm(x, h_in, p["ln1"], cfg.norm_eps, plain)
    y, tm_last, new_state = rwkv_time_mix(
        cfg, p, xn, tm_prev, state,
        state_out=state if cache is not None else None, plain=plain,
        scan=scan)
    x, xn = layers.add_norm(x, y, p["ln2"], cfg.norm_eps, plain)
    y2, cm_last = rwkv_channel_mix(cfg, p, xn, cm_prev)
    x = (y2, x) if carry else x + y2

    if cache is not None:
        if new_state is not state:
            state.copy_(new_state)
        tm_prev.copy_(tm_last)
        cm_prev.copy_(cm_last)
        return x, cache
    if build_cache_w is not None:
        return x, {"state": new_state, "tm_prev": tm_last,
                   "cm_prev": cm_last}
    return x, None
