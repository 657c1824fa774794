"""Hymba-style hybrid-head block of the port [arXiv:2411.13676]: within
every layer the normalised input goes in parallel through sliding-window
GQA attention heads and mamba-style selective-SSM heads; the two branches'
normalised outputs are averaged.

Counterpart of ``repro.models.hybrid``.  On the card the attention half
runs the hand-written kernels as in the dense block (B2 for a prefill,
with the window; B3 for a decode step on the ring cache), ln1/ln2 are
norm sites of the carried residual pair (``add_rms_norm``; B1 at layer
0's ln1) and the two branch norms ``ln_attn``/``ln_ssm`` are B1 with no
add.  The mamba branch and its selective scan stay in PyTorch: the JAX
package has no Pallas kernel for them.

Head split: n_attn = floor(num_heads · attn_head_fraction) rounded down
to a multiple of num_kv_heads (at least num_kv_heads); the remaining
heads form the SSM path with d_inner = n_ssm · head_dim.  The f32 leaves
(``b_dt``, ``A_log``, ``D``) and the scan state stay f32 whatever the
model's type, and the JAX package's type promotion is kept (a bf16
product plus the f32 bias is f32).  The per-layer cache is the ring KV
cache plus the f32 state [B, d_inner, N]; a decode step updates both in
place.

Under a ``DeviceMesh`` in ``runtime.meshctx`` the layer is one sharded
step (``_hybrid_block_sharded``): the dense block's attention site on
the n_attn heads beside a mamba site, each branch all-reduced before its
norm.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models import blocks, layers
from repro_torch.models.blocks import attention_apply
from repro_torch.models.layers import dense_init
from repro_torch.runtime import meshctx
from repro_torch.runtime import sharding as sh

F32_PARAMS = ("b_dt", "A_log", "D")     # kept in f32 whatever the model's type


def head_split(cfg: ModelConfig):
    kv = cfg.num_kv_heads
    n_attn = max(kv, int(cfg.num_heads * cfg.attn_head_fraction) // kv * kv)
    n_ssm = max(1, cfg.num_heads - n_attn)
    return n_attn, n_ssm


def init_hybrid_blocks(gen: torch.Generator, cfg: ModelConfig, L: int,
                       dtype):
    """Seeded [L, ...] block weights by the JAX package's rule, drawn from
    ``gen`` on its device (the draws differ from JAX's)."""
    n_attn, n_ssm = head_split(cfg)
    h, d = cfg.d_model, cfg.head_dim
    di, N = n_ssm * d, cfg.ssm.state_size
    dev = gen.device
    p = layers.init_attention(gen, cfg, L, dtype, n_heads=n_attn)
    p.update(layers.init_mlp(gen, h, cfg.d_ff, cfg.activation, L, dtype))
    for name in ("ln1", "ln2", "ln_attn", "ln_ssm"):
        p[name] = torch.zeros((L, h), dtype=dtype, device=dev)
    p.update({
        "in_proj": dense_init(gen, (L, h, 2 * di), dtype),
        "w_dt": dense_init(gen, (L, di, di), dtype, scale=0.01),
        # softplus(-4) ~ 0.018
        "b_dt": torch.full((L, di), -4.0, dtype=torch.float32, device=dev),
        "w_B": dense_init(gen, (L, di, N), dtype),
        "w_C": dense_init(gen, (L, di, N), dtype),
        # A = -exp(A_log) = -1
        "A_log": torch.zeros((L, di, N), dtype=torch.float32, device=dev),
        "D": torch.ones((L, di), dtype=torch.float32, device=dev),
        "ssm_out": dense_init(gen, (L, di, h), dtype),
    })
    return p


def softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (logaddexp(x, 0));
    ``F.softplus`` returns x itself above its threshold of 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def selective_scan(xm, dt, Bm, Cm, A, D, state):
    """The selective SSM recurrence, one token at a time.

    xm, dt [B, S, di]; Bm, Cm [B, S, N]; A [di, N]; D [di]; state
    [B, di, N] f32.  s_t = exp(dt_t·A)·s_{t-1} + (dt_t·x_t)·B_t and
    y_t = s_t·C_t + D·x_t, in f32.  The decays and inputs of every step
    are formed at once; the loop runs one fused multiply-add of the state
    per token, into the states of every step (their views made in one
    call).  Where grad is enabled the steps run out of place (``out=``
    takes no autograd) and are stacked: the same values.  Returns (y
    [B, S, di] in xm's type, new_state f32)."""
    xf, dtf, Bf, Cf = (t.float() for t in (xm, dt, Bm, Cm))
    decay = torch.exp(dtf[..., None] * A)                   # [B, S, di, N]
    u = (dtf * xf)[..., None] * Bf[:, :, None, :]           # [B, S, di, N]
    s = state.float()
    if torch.is_grad_enabled():
        steps = []
        for u_t, d_t in zip(u.unbind(1), decay.unbind(1)):
            s = torch.addcmul(u_t, d_t, s)
            steps.append(s)
        states = torch.stack(steps, dim=1)
    else:
        states = torch.empty_like(decay)
        for u_t, d_t, s_t in zip(u.unbind(1), decay.unbind(1),
                                 states.unbind(1)):
            s = torch.addcmul(u_t, d_t, s, out=s_t)
    y = (states * Cf[:, :, None, :]).sum(-1) + D * xf
    return y.to(xm.dtype), s.clone()


def selective_scan_chunked(xm, dt, Bm, Cm, A, D, state, chunk: int = 16):
    """Chunk-parallel selective scan (exact, pairwise log-domain).

    With T_t = Σ_{τ≤t} dt_τ (per channel d) the recurrence solution is
      s_t[d,n] = e^{A[d,n]·T_t} s_0
                 + Σ_{τ≤t} e^{A[d,n](T_t-T_τ)} dt_τ x_τ B_τ[n]
      y_t[d]   = Σ_n C_t[n] s_t[d,n] + D x_t .
    A < 0 and T is increasing, so every exponent is <= 0.  The state is
    carried once per chunk.  ``chunk`` must divide S (it clips to S)."""
    B, S, di = xm.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not divisible by the "
                         f"chunk {chunk}")
    n = S // chunk

    def to_chunks(t):                       # [B, S, ...] -> [n, B, C, ...]
        return t.float().reshape(B, n, chunk, *t.shape[2:]).transpose(0, 1)

    xc, dtc, Bc, Cc = map(to_chunks, (xm, dt, Bm, Cm))
    Af = A.float()                                            # [di, N]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xm.device))         # tau <= t
    s = state.float()
    ys = []
    for x_c, dt_c, b_c, c_c in zip(xc, dtc, Bc, Cc):
        T = torch.cumsum(dt_c, dim=1)                         # [B, C, di]
        # pairwise dT[t, tau, d] = T_t - T_tau (>= 0 for tau <= t)
        dT = T[:, :, None, :] - T[:, None, :, :]              # [B, C, C, di]
        dT = torch.where(causal[None, :, :, None], dT, torch.inf)
        E = torch.exp(Af * dT[..., None])                     # [B,C,C,di,N]
        u = dt_c * x_c                                        # [B, C, di]
        y = torch.einsum("btn,bsn,btsdn,bsd->btd", c_c, b_c, E, u)
        # inter-chunk: the decayed initial state
        decay0 = torch.exp(Af * T[..., None])                 # [B, C, di, N]
        y = y + torch.einsum("btn,btdn,bdn->btd", c_c, decay0, s)
        y = y + D * x_c
        T_end = T[:, -1:, :]                                  # [B, 1, di]
        k_hat = torch.exp(Af * (T_end - T)[..., None])        # [B, C, di, N]
        s = torch.exp(Af * T_end[:, 0, :, None]) * s \
            + torch.einsum("bsdn,bsd,bsn->bdn", k_hat, u, b_c)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, S, di)
    return y.to(xm.dtype), s


def mamba_branch(cfg: ModelConfig, p, xn, state=None):
    """xn [B, S, h] -> (out [B, S, h], new_state [B, di, N] f32)."""
    B, S, h = xn.shape
    _, n_ssm = head_split(cfg)
    di, N = n_ssm * cfg.head_dim, cfg.ssm.state_size
    if state is None:
        state = xn.new_zeros((B, di, N), dtype=torch.float32)
    xz = xn @ p["in_proj"]
    xm, z = xz[..., :di], xz[..., di:]
    dt = softplus(xm @ p["w_dt"] + p["b_dt"])               # f32
    Bm, Cm = xm @ p["w_B"], xm @ p["w_C"]
    A = -torch.exp(p["A_log"])
    if (cfg.ssm.scan_impl == "chunked" and S > 1
            and S % cfg.ssm.scan_chunk == 0):
        y, new_state = selective_scan_chunked(xm, dt, Bm, Cm, A, p["D"],
                                              state, chunk=cfg.ssm.scan_chunk)
    else:
        y, new_state = selective_scan(xm, dt, Bm, Cm, A, p["D"], state)
    return (y * F.silu(z)) @ p["ssm_out"], new_state


def init_hybrid_cache(cfg: ModelConfig, L: int, batch: int, width: int,
                      dtype, device):
    _, n_ssm = head_split(cfg)
    di, N = n_ssm * cfg.head_dim, cfg.ssm.state_size
    kv = (L, batch, width, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "ssm_state": torch.zeros((L, batch, di, N), dtype=torch.float32,
                                 device=device),
    }


def hybrid_block_apply(cfg: ModelConfig, p, x, positions, cache=None,
                       pos=None, build_cache_w=None, plain: bool = False,
                       carry: bool = False):
    """One hybrid layer.  With ``cache`` (one layer's {k, v, ssm_state})
    the cache is updated in place and returned; with ``build_cache_w`` a
    new one (the ring KV cache of width W and the final state) is
    returned; else None.  ``carry`` as in ``blocks.dense_block_apply``.
    Under a DeviceMesh the layer runs sharded (``_hybrid_block_sharded``)."""
    if meshctx.get_device_mesh() is not None:
        return _hybrid_block_sharded(cfg, p, x, positions, cache, pos,
                                     build_cache_w, plain, carry)
    h_in, x = x if carry else (None, x)
    n_attn, _ = head_split(cfg)
    x, xn = layers.add_norm(x, h_in, p["ln1"], cfg.norm_eps, plain)
    attn_cache = None if cache is None else {"k": cache["k"],
                                             "v": cache["v"]}
    attn_out, attn_cache_out = attention_apply(
        cfg, p, xn, positions, cache=attn_cache, pos=pos,
        build_cache_w=build_cache_w, plain=plain, num_heads=n_attn)
    ssm_state = None if cache is None else cache["ssm_state"]
    ssm_out, new_state = mamba_branch(cfg, p, xn, ssm_state)
    eps = cfg.norm_eps
    y = 0.5 * (layers.add_norm(attn_out @ p["wo"], None, p["ln_attn"], eps,
                               plain)[1]
               + layers.add_norm(ssm_out, None, p["ln_ssm"], eps, plain)[1])
    x, xn = layers.add_norm(x, y, p["ln2"], cfg.norm_eps, plain)
    out = layers.mlp_apply(p, xn, cfg.activation)
    out = (out, x) if carry else x + out

    if cache is not None:
        ssm_state.copy_(new_state)
        return out, cache
    if build_cache_w is not None:
        return out, {"k": attn_cache_out["k"], "v": attn_cache_out["v"],
                     "ssm_state": new_state}
    return out, None


# ---------------------------------------------------------------------------
# the sharded step (a DeviceMesh in ``runtime.meshctx``)
# ---------------------------------------------------------------------------

_MAMBA = ("in_proj", "w_dt", "b_dt", "w_B", "w_C", "A_log", "D", "ssm_out")


def _hybrid_block_sharded(cfg, p, x, positions, cache, pos, build_cache_w,
                          plain, carry):
    """``hybrid_block_apply`` on DTensors: ln1, then the attention site of
    the dense block on the n_attn attention heads (``blocks``) and the
    mamba site (``_mamba_sharded``) side by side; each branch's output,
    a partial sum over "model" where its last product is row-parallel, is
    all-reduced before its branch norm (a norm of a partial sum is not
    the norm of the sum), so their mean reaches ln2 whole; then the MLP
    site."""
    n_attn, _ = head_split(cfg)
    eps = cfg.norm_eps
    h_in, x = x if carry else (None, x)
    x, xn = layers.add_norm(x, h_in, p["ln1"], eps, plain)
    attn_cache = None if cache is None else {"k": cache["k"],
                                             "v": cache["v"]}
    y_attn, attn_cache_out = blocks._attention_sharded(
        cfg, p, xn, positions, attn_cache, pos, build_cache_w, plain, 0,
        num_heads=n_attn)
    y_ssm, new_state = _mamba_sharded(
        cfg, p, xn, None if cache is None else cache["ssm_state"],
        build=build_cache_w is not None)
    a = layers.add_norm(sh.reduce_branch(y_attn), None, p["ln_attn"], eps,
                        plain)[1]
    b = layers.add_norm(sh.reduce_branch(y_ssm), None, p["ln_ssm"], eps,
                        plain)[1]
    y = sh.local_site(lambda a, b: 0.5 * (a + b), a.placements, a, b)
    x, xn = layers.add_norm(x, y, p["ln2"], eps, plain)
    out = blocks.close_sharded(x, blocks._mlp_sharded(p, xn, cfg.activation),
                               carry)
    if cache is not None:
        return out, cache
    if build_cache_w is not None:
        return out, {"k": attn_cache_out["k"], "v": attn_cache_out["v"],
                     "ssm_state": new_state}
    return out, None


def _mamba_sharded(cfg, p, xn, state, build: bool):
    """The mamba branch of a sharded step, one site on the local shards ->
    (out [B, S, h]; the new state [B, di, N] when ``build``, else None;
    ``state``, a decode step's, is updated in place).  The leaves split by
    divisibility, so three layouts:

      * d_inner split (its leaves and the state on the rank's di/m
        channels): in_proj's column blocks of [xm | z] do not line up with
        the channels, so xz is all-gathered over "model" (each rank's
        w_dt columns read every channel of xm anyway); dt of the rank's
        channels, B and C from row-parallel w_B / w_C (one all-reduce of
        their partial sums, side by side), the scan on the rank's
        channels, ssm_out row-parallel: the output is a partial sum;
      * in_proj split alone: xz all-gathered, the rest on every rank, the
        output whole;
      * nothing split: every rank the whole branch, the output whole."""
    from torch.distributed.tensor import Shard
    _, n_ssm = head_split(cfg)
    di, N = n_ssm * cfg.head_dim, cfg.ssm.state_size
    in_split = sh.model_sharded(p["in_proj"])
    di_split = all(sh.model_sharded(p[n]) for n in _MAMBA[1:])
    if not di_split and any(sh.model_sharded(p[n]) for n in _MAMBA[1:]):
        raise NotImplementedError("the mamba branch's d_inner leaves split "
                                  "apart")
    m, r = sh.axis_size("model"), sh.model_rank()
    dl = di // m if di_split else di
    c0 = r * dl if di_split else 0

    def local(xn, in_proj, w_dt, b_dt, w_B, w_C, A_log, D, ssm_out, *st):
        if st:
            state = st[0]
        else:
            state = xn.new_zeros((xn.shape[0], dl, N), dtype=torch.float32)
        xz = (sh.copy_to_model(xn) if in_split else xn) @ in_proj
        if in_split:
            gather = sh.gather_model if di_split else sh.gather_replicated
            xz = gather(xz, -1)
        xm = xz[..., :di]
        xm_l, z = xm[..., c0:c0 + dl], xz[..., di + c0:di + c0 + dl]
        dt = softplus(xm @ w_dt + b_dt)                     # f32
        bc = torch.cat([xm_l @ w_B, xm_l @ w_C], dim=-1)
        if di_split:
            bc = sh.reduce_model_shared(bc)
        Bm, Cm = bc[..., :N], bc[..., N:]
        A = -torch.exp(A_log)
        S = xn.shape[1]
        if (cfg.ssm.scan_impl == "chunked" and S > 1
                and S % cfg.ssm.scan_chunk == 0):
            y, new_state = selective_scan_chunked(
                xm_l, dt, Bm, Cm, A, D, state, chunk=cfg.ssm.scan_chunk)
        else:
            y, new_state = selective_scan(xm_l, dt, Bm, Cm, A, D, state)
        out = (y * F.silu(z)) @ ssm_out
        if st:
            state.copy_(new_state)
            return out
        return (out, new_state) if build else out

    act = xn.placements
    out_pl = sh.partial_model(act) if di_split else act
    args = [xn] + [p[n] for n in _MAMBA]
    weights = tuple(range(1, len(args)))
    if state is not None:
        return sh.local_site(local, out_pl, *args, state,
                             weights=weights), None
    if not build:
        return sh.local_site(local, out_pl, *args, weights=weights), None
    st_pl = sh.with_model(act, Shard(1)) if di_split else act
    return sh.local_site(local, (out_pl, st_pl), *args, weights=weights)
