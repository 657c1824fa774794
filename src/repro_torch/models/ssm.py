"""RWKV-6 (Finch) block of the port: token-shifted time-mix with
data-dependent decay and a squared-ReLU channel-mix [arXiv:2404.05892].

Counterpart of ``repro.models.ssm``.  The WKV recurrence goes through
kernel B10 on the card (``kernels.rwkv6_scan.wkv6``), ``ln1``/``ln2``
through B1; ``plain=True`` runs their plain versions, the path the
kernels are held to on the whole model.  The per-layer cache is the f32
recurrent state and the two token-shift registers, O(1) in the sequence
length; a decode step updates it in place (the JAX package returned a
new one).

Under a ``DeviceMesh`` in ``runtime.meshctx`` the layer is one sharded
step (``_ssm_block_sharded``): the time mix and the channel mix each a
site on the rank's heads and columns.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.rwkv6_scan.chunked import wkv6_chunked
from repro_torch.kernels.rwkv6_scan.ops import wkv6
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref
from repro_torch.models import blocks, layers
from repro_torch.models.layers import dense_init
from repro_torch.runtime import meshctx
from repro_torch.runtime import sharding as sh

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
                  plain: bool = False, scan=None, heads: int = None,
                  copy=None):
    """x [B,S,h]; prev_x [B,h]; state [B,H,hs,hs] f32 -> (y, last_x,
    new_state).  The kernel path writes the new state into ``state_out``
    when one is given.  ``scan`` (``wkv6_ref``'s signature), when given,
    computes the recurrence in place of the model's own.  ``heads`` is the
    head count of the weights in ``p`` (a sharded step's H/m: wr, wk, wv,
    wg, u and the head norm's and the decay's columns of them; the
    config's by default); ``copy`` wraps each input of a product whose
    weight is split over the heads (``sharding.copy_to_model``)."""
    B, S, h = x.shape
    H, hs = cfg.num_heads if heads is None else heads, cfg.ssm.head_size
    f = copy or (lambda t: t)
    xs = _shift(x, prev_x)

    def mix(m):
        return x + (xs - x) * m

    r = (f(mix(p["mx_r"])) @ p["wr"]).reshape(B, S, H, hs)
    k = (f(mix(p["mx_k"])) @ p["wk"]).reshape(B, S, H, hs)
    v = (f(mix(p["mx_v"])) @ p["wv"]).reshape(B, S, H, hs)
    g = F.silu(f(mix(p["mx_g"])) @ p["wg"])
    dw = p["w0"] + f(torch.tanh(mix(p["mx_w"]) @ p["wa"])) @ p["wb"]
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
    y = _head_norm(y.reshape(B, S, H * hs), p["ln_x"], H, hs, cfg.norm_eps)
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
    adds fused into the norm sites, as ``blocks.dense_block_apply`` does.
    Under a DeviceMesh the layer runs sharded (``_ssm_block_sharded``)."""
    if meshctx.get_device_mesh() is not None:
        return _ssm_block_sharded(cfg, p, x, cache, build_cache_w, plain,
                                  scan, carry)
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


# ---------------------------------------------------------------------------
# the sharded step (a DeviceMesh in ``runtime.meshctx``)
# ---------------------------------------------------------------------------

_TIME_MIX = ("wr", "wk", "wv", "wg", "wo", "u", "wa", "wb", "w0", "ln_x",
             "mx_r", "mx_k", "mx_v", "mx_w", "mx_g")
_CHANNEL_MIX = ("cwk", "cwv", "cwr", "cmx_k", "cmx_r")


def _ssm_block_sharded(cfg, p, x, cache, build_cache_w, plain, scan, carry):
    """``ssm_block_apply`` on DTensors: the norm sites of the dense block
    (``layers.add_norm``), the time mix and the channel mix each one site
    on the local shards.

      * Time mix: wr, wk, wv and wg column-parallel over the heads (each
        input through ``copy_to_model``), u and the state on the rank's
        H/m heads, B10 (or its plain version) on them; the replicated
        decay LoRA's wb and w0 and the head norm's ln_x sliced to the
        rank's columns (their gradients summed over "model"); wo
        row-parallel: the output is a partial sum, all-reduced by ln2.
      * Channel mix: cwk column-parallel, cwv row-parallel, so k @ cwv is
        a partial sum while the gate's cwr is column-parallel: the value
        is reduce-scattered to the rank's columns, gated there, and
        all-gathered: the output is whole on every rank.

    The token-shift registers stay whole over "model"."""
    from torch.distributed.tensor import Shard
    H, hs = cfg.num_heads, cfg.ssm.head_size
    m, r = sh.axis_size("model"), sh.model_rank()
    split = ("wr", "wk", "wv", "wg", "wo", "u", "cwk", "cwv", "cwr")
    if H % m or not all(sh.model_sharded(p[n]) for n in split):
        raise NotImplementedError("a sharded RWKV-6 layer needs the heads "
                                  "and d_ff to divide the model axis")
    Hl = H // m
    cols = slice(r * Hl * hs, (r + 1) * Hl * hs)
    h_in, x = x if carry else (None, x)
    x, xn = layers.add_norm(x, h_in, p["ln1"], cfg.norm_eps, plain)
    act = xn.placements        # also a [B, h] row's (batch dim 0, whole h)
    state_pl = sh.with_model(act, Shard(1))

    def time_mix(xn, *args):
        w = dict(zip(_TIME_MIX, args[:len(_TIME_MIX)]))
        for name in ("wb", "w0", "ln_x"):
            w[name] = sh.reduce_model_grad(w[name])[..., cols]
        if cache is None:
            b = xn.shape[0]
            prev = xn.new_zeros((b, xn.shape[-1]))
            state = xn.new_zeros((b, Hl, hs, hs), dtype=torch.float32)
        else:
            prev, state = args[len(_TIME_MIX):]
        y, last, new_state = rwkv_time_mix(
            cfg, w, xn, prev, state,
            state_out=state if cache is not None else None, plain=plain,
            scan=scan, heads=Hl, copy=sh.copy_to_model)
        if cache is not None:
            if new_state is not state:
                state.copy_(new_state)
            prev.copy_(last)
            return y
        if build_cache_w is None:
            return y
        return y, last, new_state

    args = [p[n] for n in _TIME_MIX]
    weights = tuple(range(1, len(args) + 1))
    y_pl = sh.partial_model(act)
    if cache is not None:
        y = sh.local_site(time_mix, y_pl, xn, *args, cache["tm_prev"],
                          cache["state"], weights=weights)
    elif build_cache_w is None:
        y = sh.local_site(time_mix, y_pl, xn, *args, weights=weights)
    else:
        y, tm_last, new_state = sh.local_site(
            time_mix, (y_pl, act, state_pl), xn, *args, weights=weights)
    x, xn = layers.add_norm(x, y, p["ln2"], cfg.norm_eps, plain)

    def channel_mix(xn, cwk, cwv, cwr, cmx_k, cmx_r, *prev):
        prev = prev[0] if prev else xn.new_zeros((xn.shape[0],
                                                  xn.shape[-1]))
        xs = _shift(xn, prev)
        xk = xn + (xs - xn) * cmx_k
        xr = xn + (xs - xn) * cmx_r
        k = torch.square(torch.relu(sh.copy_to_model(xk) @ cwk))
        v = sh.scatter_model(k @ cwv, -1)
        out = sh.gather_replicated(
            torch.sigmoid(sh.copy_to_model(xr) @ cwr) * v, -1)
        if cache is not None:
            prev.copy_(xn[:, -1, :])
            return out
        if build_cache_w is None:
            return out
        return out, xn[:, -1, :]

    args = [p[n] for n in _CHANNEL_MIX]
    weights = tuple(range(1, len(args) + 1))
    if cache is not None:
        y2 = sh.local_site(channel_mix, act, xn, *args, cache["cm_prev"],
                           weights=weights)
    elif build_cache_w is None:
        y2 = sh.local_site(channel_mix, act, xn, *args, weights=weights)
    else:
        y2, cm_last = sh.local_site(channel_mix, (act, act), xn, *args,
                                    weights=weights)
    out = blocks.close_sharded(x, y2, carry)
    if cache is not None:
        return out, cache
    if build_cache_w is not None:
        return out, {"state": new_state, "tm_prev": tm_last,
                     "cm_prev": cm_last}
    return out, None
