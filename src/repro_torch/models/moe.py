"""Mixture-of-Experts block of the port: top-k routing with capacity-based
sorted dispatch.

Counterpart of ``repro.models.moe`` on its GSPMD path (``moe_ffn``: the
dispatch over the call's whole token set).  The attention half and the
norm sites go through the hand-written kernels as in the dense block
(``blocks`` module doc: B1 and ``add_rms_norm`` at ln1/ln2, B2 for a
prefill, B3 for a decode step on the ring cache); the router, the
dispatch, the stacked expert GEMMs (``torch.bmm``) and the combine stay
in PyTorch, as the JAX package computes them outside any Pallas kernel.

Semantics kept from the JAX package:
  * the router runs in f32: an f32 parameter, ``x.float() @ router``;
  * softmax, then top-k, then the top-k probabilities renormalised (their
    sum clamped at 1e-9); the auxiliary loss E·Σ(mean_prob·frac_tok)·coef;
  * the (token, choice) pairs are sorted by expert with a stable sort, and
    a pair's position within its expert decides whether it fits the
    ``capacity`` (``moe_capacity`` of the call's token count B·S), so the
    same pairs drop as in JAX; a dropped pair contributes nothing.

The dispatch is a gather: buffer row (e, c) of the dense [E, capacity, h]
buffer takes the token of sorted pair offsets[e] + c when c < counts[e]
(zeros otherwise), which is what JAX's scatter into the buffer writes.
The combine is a gather too, with no atomics, so it is deterministic on
the card: each token's K weighted expert rows, ``ye[slot] · p`` rounded to
the model's type as in JAX, are summed one at a time in ascending expert
id, each add rounded to the model's type.  That is the order in which
JAX's scatter-add applies a token's updates (they are sorted by expert),
so the port rounds as JAX's bf16 scatter-add does when XLA applies the
updates one by one; an f32 model sums the same terms in the same order.

The auxiliary loss of each layer is appended to ``aux_out`` when the
trunk passes a list (``Model.forward`` sums them).

``moe_ffn_local`` is the counterpart of JAX's shard_map path on a
``core.comm.VirtualMesh``: each data shard routes its own tokens, the
experts are tensor-parallel over the t ranks of the ``model`` axis (f
split), and the ranks' partial outputs meet in one logged all-reduce a
layer.  ``moe_block_apply`` takes it exactly where JAX's does: with
``cfg.moe_dispatch == "local"`` and a mesh with a ``model`` axis set in
``runtime.meshctx``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.blocks import attention_apply
from repro_torch.models.layers import dense_init, mlp_apply
from repro_torch.runtime import meshctx

F32_PARAMS = ("router",)     # kept in f32 whatever the model's type


def _stacked_init(gen: torch.Generator, shape, dtype):
    """``dense_init`` of an [L, ...] weight drawn one layer at a time into
    one preallocated tensor (normal / sqrt(fan_in), fan_in = shape[-2]):
    the f32 draw of a whole [L, E, h, f] expert stack would not fit beside
    the model at full width."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for layer in out:
        layer.copy_(dense_init(gen, tuple(shape[1:]), dtype))
    return out


def init_moe_blocks(gen: torch.Generator, cfg: ModelConfig, L: int, dtype):
    """Seeded [L, ...] block weights by the JAX package's rule, drawn from
    ``gen`` on its device (the draws differ from JAX's)."""
    moe = cfg.moe
    h, f, E = cfg.d_model, moe.expert_d_ff, moe.num_experts
    p = layers.init_attention(gen, cfg, L, dtype)
    p["router"] = dense_init(gen, (L, h, E), torch.float32)
    p["we1"] = _stacked_init(gen, (L, E, h, f), dtype)
    p["we2"] = _stacked_init(gen, (L, E, f, h), dtype)
    p["we3"] = _stacked_init(gen, (L, E, h, f), dtype)
    if moe.num_shared_experts:
        sf = moe.shared_d_ff * moe.num_shared_experts
        p.update({f"s{k}": v for k, v in layers.init_mlp(
            gen, h, sf, cfg.activation, L, dtype).items()})
    for name in ("ln1", "ln2"):
        p[name] = torch.zeros((L, h), dtype=dtype, device=gen.device)
    return p


def moe_capacity(tokens: int, cfg: ModelConfig) -> int:
    """Buffer rows per expert for a call over ``tokens`` tokens."""
    moe = cfg.moe
    cap = int(math.ceil(tokens * moe.top_k / moe.num_experts
                        * moe.capacity_factor))
    return min(max(cap, moe.top_k), tokens * moe.top_k)


def route(cfg: ModelConfig, router, xf):
    """(top_p [T, K] renormalised f32, top_i [T, K] expert ids, probs
    [T, E] f32) of tokens xf [T, h] under the f32 router; the K choices
    in top-k order."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.moe.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_i, probs


def moe_ffn(cfg: ModelConfig, p, x):
    """x [B, S, h] -> (y [B, S, h], aux loss f32 scalar): the routed
    experts over the call's B·S tokens, plus the shared experts."""
    moe = cfg.moe
    B, S, h = x.shape
    T = B * S
    xf = x.reshape(T, h)
    y, aux = _moe_compute(cfg, p, xf, moe_capacity(T, cfg))
    if moe.num_shared_experts:
        y = y + mlp_apply({"w1": p["sw1"], "w2": p["sw2"],
                           "w3": p.get("sw3")}, xf, cfg.activation)
    return y.reshape(B, S, h), aux


def dispatch_plan(top_i, num_experts: int, cap: int):
    """The sorted dispatch of the choices top_i [T, K] (each row in
    ascending expert id): (order [T*K], the (token, choice) pairs stably
    sorted by expert; counts [E] and offsets [E] of each expert's run in
    that order; keep [T, K], whether a choice fits its expert's ``cap``
    rows; slot [T, K], its row e·cap + position in the [E·cap + 1, h]
    buffer, E·cap (the overflow row) when dropped)."""
    T, K = top_i.shape
    dev = top_i.device
    flat_e = top_i.reshape(-1)                                # [T*K]
    counts = (flat_e[:, None] == torch.arange(num_experts,
                                              device=dev)).sum(0)
    offsets = torch.cumsum(counts, 0) - counts
    order = torch.argsort(flat_e, stable=True)
    # pair j = t*K + k sits at sorted position rank[j]
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * K, device=dev))
    pos_in_e = rank - offsets[flat_e]
    keep = pos_in_e < cap
    slot = torch.where(keep, flat_e * cap + pos_in_e, num_experts * cap)
    return order, counts, offsets, keep.reshape(T, K), slot.reshape(T, K)


def _moe_compute(cfg: ModelConfig, p, xf, cap: int):
    """The routed experts on a flat token block xf [T, h] with ``cap``
    buffer rows per expert -> (y [T, h], aux)."""
    plan, aux = _dispatch(cfg, p["router"], xf, cap)
    return _experts(cfg, p, plan), aux


def _dispatch(cfg: ModelConfig, router, xf, cap: int):
    """Route tokens xf [T, h] and fill the dense [E, cap, h] buffer ->
    (plan, aux): the plan is what ``_experts`` needs (the buffer xe, each
    token's K buffer rows and weights, in ascending expert id)."""
    moe = cfg.moe
    E, K = moe.num_experts, moe.top_k
    T, h = xf.shape

    top_p, top_i, probs = route(cfg, router, xf)
    # each token's choices in ascending expert id: the stable sort by
    # expert orders a token's pairs the same way either way (one expert
    # holds a token at most once), and the combine sums them so
    top_i, perm = torch.sort(top_i, dim=-1)
    top_p = top_p.gather(-1, perm)
    order, counts, offsets, keep, slot = dispatch_plan(top_i, E, cap)
    frac_tok = counts.float() / (T * K)
    aux = E * torch.sum(probs.mean(dim=0) * frac_tok) * moe.router_aux_coef

    # dispatch: buffer row (e, c) <- the token of sorted pair offsets[e] + c
    c_idx = torch.arange(cap, device=xf.device)
    filled = c_idx[None, :] < counts[:, None]                 # [E, cap]
    src = torch.where(filled, offsets[:, None] + c_idx[None, :], 0)
    xe = torch.where(filled[..., None], xf[order[src] // K], 0)
    return {"xe": xe, "slot": slot, "keep": keep, "top_p": top_p}, aux


def _experts(cfg: ModelConfig, p, plan):
    """The stacked expert GLU on the dispatched buffer (the f columns
    ``p``'s we1/we3 hold and the rows its we2 holds), then the combine:
    y [T, h]."""
    xe, slot = plan["xe"], plan["slot"]
    E, cap, h = xe.shape
    up = torch.bmm(xe, p["we1"])
    gate = F.silu(up) if cfg.activation == "swiglu" else \
        F.gelu(up, approximate="tanh")
    act = gate * torch.bmm(xe, p["we3"])
    ye = torch.bmm(act, p["we2"]).reshape(E * cap, h)
    ye = torch.cat([ye, ye.new_zeros((1, h))])                # overflow row

    # combine: a token's K rows, weighted, summed in ascending expert id
    weight = (plan["top_p"] * plan["keep"]).to(ye.dtype)
    parts = ye[slot] * weight[..., None]                      # [T, K, h]
    y = parts[:, 0]
    for k in range(1, parts.shape[1]):
        y = y + parts[:, k]
    return y


def _rank_weights(cfg: ModelConfig, p, r: int, t: int) -> dict:
    """Model rank r's block of the expert stacks (of t): the f columns of
    we1/we3 and the f rows of we2, and likewise of the shared experts'
    sw1/sw3 and sw2."""
    f = cfg.moe.expert_d_ff
    if f % t:
        raise ValueError(f"expert d_ff {f} does not split over t={t}")
    cols = slice(r * f // t, (r + 1) * f // t)
    out = {"we1": p["we1"][..., cols], "we3": p["we3"][..., cols],
           "we2": p["we2"][:, cols]}
    if cfg.moe.num_shared_experts:
        sf = p["sw1"].shape[-1]
        sc = slice(r * sf // t, (r + 1) * sf // t)
        out.update(sw1=p["sw1"][:, sc], sw2=p["sw2"][sc])
        if "sw3" in p:
            out["sw3"] = p["sw3"][:, sc]
    return out


def _gather_experts(w: dict, group) -> dict:
    """The just-in-time all-gather over ``data`` of one model rank's
    expert stacks when they are also split on h over the data ranks
    (``moe_fsdp``): we1/we3 on their h axis (1), we2 on its h axis (2)."""
    d = group.t
    out = dict(w)
    for name, axis in (("we1", 1), ("we3", 1), ("we2", 2)):
        out[name] = group.all_gather(list(w[name].chunk(d, dim=axis)),
                                     axis=axis)
    return out


def moe_ffn_local(cfg: ModelConfig, p, x, mesh, with_aux: bool = True):
    """Expert-TP MoE over a ``core.comm.VirtualMesh`` with a ``model``
    axis: x [B, S, h] -> (y [B, S, h], aux), following JAX's
    ``moe_ffn_local`` step for step.

    The batch is split over the data axes ("pod", "data") when it
    divides (B % dp == 0 and B >= dp); each data shard routes and
    dispatches its own tokens against its own ``moe_capacity``, so the
    drops are those of JAX's shard_map path.  The routing is computed
    once a shard (JAX's model ranks compute it identically, with no
    collective).  Each of the t model ranks runs the experts on its f
    block (``_rank_weights``) plus its block of the shared experts; the
    partials are summed by one all-reduce over ``model``, in rank order.
    The aux loss is averaged over the data shards (an all-reduce over
    the data axes, then / dp).  With ``cfg.moe_fsdp`` and h divisible
    over ``data``, each rank's stacks arrive by three all-gathers over
    ``data`` first.  The data shards' collectives at one site are logged
    once (``core.comm``).  ``with_aux=False`` (a pass that drops the aux
    loss: prefill, decode) returns aux None and skips its all-reduce, as
    XLA drops the unused ``pmean`` from JAX's compiled prefill."""
    B, S, h = x.shape
    moe = cfg.moe
    baxes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    dp = math.prod(mesh.shape[a] for a in baxes)
    split = B % dp == 0 and B >= dp
    shards = x.chunk(dp) if split else (x,)
    t_loc = (B // dp if split else B) * S
    cap = moe_capacity(t_loc, cfg)
    model = mesh.group("model")
    t = model.t
    fsdp = (cfg.moe_fsdp and "data" in mesh.shape
            and h % mesh.shape["data"] == 0)
    ranks = [_rank_weights(cfg, p, r, t) for r in range(t)]
    if fsdp:
        data = mesh.group("data")
        gathered = []
        for r, w in enumerate(ranks):
            with data.muted(r > 0):
                gathered.append(_gather_experts(w, data))
        ranks = gathered

    ys, auxes = [], []
    for i, xs in enumerate(shards):
        xf = xs.reshape(-1, h)
        plan, aux = _dispatch(cfg, p["router"], xf, cap)
        partials = []
        for w in ranks:
            y = _experts(cfg, w, plan)
            if moe.num_shared_experts:
                y = y + mlp_apply({"w1": w["sw1"], "w2": w["sw2"],
                                   "w3": w.get("sw3")}, xf, cfg.activation)
            partials.append(y)
        with model.muted(i > 0):
            ys.append(model.all_reduce(partials).reshape(xs.shape))
        auxes.append(aux)
    if not with_aux:
        aux = None
    elif split:
        aux = mesh.group(baxes).all_reduce([a.reshape(1) for a in auxes])
        aux = (aux / dp).reshape(())
    return torch.cat(ys) if split else ys[0], aux


def moe_block_apply(cfg: ModelConfig, p, x, positions, cache=None, pos=None,
                    build_cache_w=None, plain: bool = False,
                    carry: bool = False, aux_out=None):
    """One MoE layer: GQA attention, then the routed (and shared) experts
    in place of the MLP (on the expert-TP path when ``cfg.moe_dispatch``
    is "local" and ``meshctx`` holds a mesh with a ``model`` axis).  ``carry``, ``cache`` and ``build_cache_w`` as in
    ``blocks.dense_block_apply``; the layer's aux loss is appended to
    ``aux_out`` when it is a list."""
    h_in, x = x if carry else (None, x)
    x, xn = layers.add_norm(x, h_in, p["ln1"], cfg.norm_eps, plain)
    attn_out, cache_out = attention_apply(
        cfg, p, xn, positions, cache=cache, pos=pos,
        build_cache_w=build_cache_w, plain=plain)
    x, xn = layers.add_norm(x, attn_out @ p["wo"], p["ln2"], cfg.norm_eps,
                            plain)
    mesh = meshctx.get_mesh()
    if (cfg.moe_dispatch == "local" and mesh is not None
            and "model" in mesh.shape):
        y, aux = moe_ffn_local(cfg, p, xn, mesh,
                               with_aux=aux_out is not None)
    else:
        y, aux = moe_ffn(cfg, p, xn)
    if aux_out is not None:
        aux_out.append(aux)
    return ((y, x) if carry else x + y), cache_out
