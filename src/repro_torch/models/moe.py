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

Under a ``DeviceMesh`` in ``runtime.meshctx`` the layer is one sharded
step (``_moe_block_sharded``): the dense block's attention and norm
sites, then the experts as one site.  On the GSPMD dispatch that is
``_moe_ffn_sharded``, the GSPMD path's values (the dispatch over the
global token set) from each rank's own experts and data shard.  On the
local dispatch (``cfg.moe_dispatch == "local"``, the mesh with a "model"
axis) it is ``_moe_ffn_local_sharded``, JAX's shard_map path: each data
shard routes its own tokens against its own capacity, the expert stacks
run split on f (redistributed from the expert axis by all-to-alls where
they are stored there; gathered over "data" under ``moe_fsdp``), and one
all-reduce over "model" a layer closes them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models import blocks, layers
from repro_torch.models.blocks import attention_apply
from repro_torch.models.layers import dense_init, mlp_apply
from repro_torch.runtime import meshctx
from repro_torch.runtime import sharding as sh

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


def dispatch_plan(top_i, num_experts: int, cap: int, before=None,
                  experts=None):
    """The sorted dispatch of the choices top_i [T, K] (each row in
    ascending expert id): (order [T*K], the (token, choice) pairs stably
    sorted by expert; counts [E] and offsets [E] of each expert's run in
    that order; keep [T, K], whether a choice fits its expert's ``cap``
    rows and its expert is in ``experts``; slot [T, K], its row
    (e - e0)·rows + position in the [(e1 - e0)·rows + 1, h] buffer,
    rows = min(cap, T·K), the last row (the overflow row) when dropped).

    ``before`` [E] counts each expert's pairs in the tokens ahead of these
    (the earlier data shards' on a sharded step, where the T tokens are
    one shard's): a pair's place in its expert's queue, which decides
    whether it fits, is its place here plus those.  ``experts`` (e0, e1)
    are the experts whose rows the buffer holds (a model rank's; all by
    default)."""
    T, K = top_i.shape
    dev = top_i.device
    e0, e1 = (0, num_experts) if experts is None else experts
    rows = min(cap, T * K)
    flat_e = top_i.reshape(-1)                                # [T*K]
    counts = _counts(top_i, num_experts)
    offsets = torch.cumsum(counts, 0) - counts
    order = torch.argsort(flat_e, stable=True)
    # pair j = t*K + k sits at sorted position rank[j]
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * K, device=dev))
    pos_in_e = rank - offsets[flat_e]
    queued = pos_in_e if before is None else pos_in_e + before[flat_e]
    keep = queued < cap
    if experts is not None:
        keep = keep & (flat_e >= e0) & (flat_e < e1)
    slot = torch.where(keep, (flat_e - e0) * rows + pos_in_e,
                       (e1 - e0) * rows)
    return order, counts, offsets, keep.reshape(T, K), slot.reshape(T, K)


def _moe_compute(cfg: ModelConfig, p, xf, cap: int):
    """The routed experts on a flat token block xf [T, h] with ``cap``
    buffer rows per expert -> (y [T, h], aux)."""
    plan, aux = _dispatch(cfg, p["router"], xf, cap)
    return _experts(cfg, p, plan), aux


def _routed(cfg: ModelConfig, router, xf):
    """``route``'s (top_p, top_i, probs) with each token's choices in
    ascending expert id: the stable sort by expert orders a token's pairs
    the same way either way (one expert holds a token at most once), and
    the combine sums them so."""
    top_p, top_i, probs = route(cfg, router, xf)
    top_i, perm = torch.sort(top_i, dim=-1)
    return top_p.gather(-1, perm), top_i, probs


def _dispatch(cfg: ModelConfig, router, xf, cap: int):
    """Route tokens xf [T, h] and fill the dense [E, cap, h] buffer ->
    (plan, aux): the plan is what ``_experts`` needs (the buffer xe, each
    token's K buffer rows and weights, in ascending expert id)."""
    top_p, top_i, probs = _routed(cfg, router, xf)
    plan, counts = _fill(cfg, xf, top_p, top_i, cap)
    return plan, _aux_loss(cfg, probs.mean(dim=0), counts, xf.shape[0])


def _aux_loss(cfg: ModelConfig, mean_prob, counts, T: int):
    """E·Σ(mean_prob·frac_tok)·coef of T tokens' mean routing
    probabilities mean_prob [E] and the experts' counts [E] of their T·K
    pairs."""
    moe = cfg.moe
    frac_tok = counts.float() / (T * moe.top_k)
    return (moe.num_experts * torch.sum(mean_prob * frac_tok)
            * moe.router_aux_coef)


def _fill(cfg: ModelConfig, xf, top_p, top_i, cap: int, before=None,
          experts=None):
    """The plan of ``_dispatch`` for routed tokens xf [T, h] (``before``
    and ``experts`` as ``dispatch_plan``'s) and the experts' counts [E]:
    buffer row (e, c) <- the token of sorted pair offsets[e] + c while
    that pair fits."""
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    e0, e1 = (0, E) if experts is None else experts
    shard = () if before is None and experts is None else (before, experts)
    order, counts, offsets, keep, slot = dispatch_plan(top_i, E, cap, *shard)
    rows = min(cap, top_i.numel())
    c_idx = torch.arange(rows, device=xf.device)
    fits = counts[e0:e1]
    if before is not None:
        fits = torch.minimum(fits, (cap - before[e0:e1]).clamp(min=0))
    filled = c_idx[None, :] < fits[:, None]                   # [E', rows]
    src = torch.where(filled, offsets[e0:e1, None] + c_idx[None, :], 0)
    xe = torch.where(filled[..., None], xf[order[src] // K], 0)
    return {"xe": xe, "slot": slot, "keep": keep, "top_p": top_p}, counts


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
    is "local" and ``meshctx`` holds a mesh with a ``model`` axis; as one
    sharded step under a DeviceMesh, ``_moe_block_sharded``, on either
    dispatch).  ``carry``, ``cache`` and ``build_cache_w`` as in
    ``blocks.dense_block_apply``; the layer's aux loss is appended to
    ``aux_out`` when it is a list."""
    if meshctx.get_device_mesh() is not None:
        return _moe_block_sharded(cfg, p, x, positions, cache, pos,
                                  build_cache_w, plain, carry, aux_out)
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


# ---------------------------------------------------------------------------
# the sharded step (a DeviceMesh in ``runtime.meshctx``)
# ---------------------------------------------------------------------------


def _moe_block_sharded(cfg, p, x, positions, cache, pos, build_cache_w,
                       plain, carry, aux_out):
    """``moe_block_apply`` on DTensors: the dense block's norm sites and
    attention site (``blocks``), then the routed and shared experts as one
    site whose output is a partial sum over "model": the local dispatch
    (``_moe_ffn_local_sharded``) where ``cfg.moe_dispatch`` is "local" and
    the mesh has a "model" axis, as JAX takes its shard_map path, else the
    GSPMD path's values (``_moe_ffn_sharded``)."""
    h_in, x = x if carry else (None, x)
    x, xn = layers.add_norm(x, h_in, p["ln1"], cfg.norm_eps, plain)
    y, cache_out = blocks._attention_sharded(cfg, p, xn, positions, cache,
                                             pos, build_cache_w, plain, 0)
    x, xn = layers.add_norm(x, y, p["ln2"], cfg.norm_eps, plain)
    local = (cfg.moe_dispatch == "local"
             and "model" in sh.device_mesh().mesh_dim_names)
    ffn = _moe_ffn_local_sharded if local else _moe_ffn_sharded
    out, aux = ffn(cfg, p, xn, with_aux=aux_out is not None)
    if aux_out is not None:
        aux_out.append(aux)
    return blocks.close_sharded(x, out, carry), cache_out


_STACKS = ("we1", "we2", "we3")
# an expert stack's f axis and h axis in one layer's [E, h, f] / [E, f, h]
_F_DIM = {"we1": 2, "we2": 1, "we3": 2}
_H_DIM = {"we1": 1, "we2": 2, "we3": 1}


def _moe_ffn_sharded(cfg: ModelConfig, p, xn, with_aux: bool):
    """The routed (and shared) experts of a sharded step, one site on the
    local shards: xn [B, S, h] (split over the batch axes, whole over
    "model") -> (y, a partial sum over "model"; aux, replicated, or None
    when ``with_aux`` is False).  The values are ``moe_ffn``'s, whose
    dispatch runs over the global token set:

      * every model rank routes its data shard's tokens (the router is
        replicated), then runs the pairs of its own experts (the stacks
        split on the expert axis) or its f block of every expert (split
        on f, where the experts do not divide "model"), into a buffer of
        min(cap, its pairs) rows an expert, and scatters them back
        weighted: a partial sum, to which the shared experts' column /
        row-parallel GLU adds its own;
      * the capacity is the global call's (``moe_capacity`` of B·S), and
        a pair's place in its expert's queue counts the pairs of the data
        shards ahead of it: the experts' counts of every shard arrive by
        one all-gather over the batch axes (none where the batch is not
        split over them);
      * the aux loss takes mean_prob over every token (one all-reduce of
        the probabilities' sum over the batch axes) and frac_tok from the
        gathered counts.

    In the backward, the tokens' and the routing weights' gradients are
    all-reduced over "model" (``copy_to_model``: each rank's pairs give a
    part of them)."""
    E = cfg.moe.num_experts
    B, S, _ = xn.shape
    T = B * S
    cap = moe_capacity(T, cfg)
    if any(sh.split_over_batch(p[n]) for n in _STACKS):
        raise NotImplementedError("expert stacks split over the batch axes "
                                  "(moe_fsdp) are not sharded")
    # one layer's [E, h, f] / [E, f, h] stacks: split on E, or on f
    dims = tuple(sh.model_dim(p[n]) for n in _STACKS)
    if dims == (0, 0, 0):
        m, r = sh.axis_size("model"), sh.model_rank()
        experts = (r * E // m, (r + 1) * E // m)
    elif dims == (2, 1, 2):
        experts = None
    else:
        raise NotImplementedError("a sharded MoE needs the experts or their "
                                  "d_ff to divide the model axis")
    split = sh.batch_sharded(xn)

    def queue(top_i):
        if not split:
            return cap, None, experts, None
        every = sh.gather_batch_values(_counts(top_i, E).to(torch.int32))
        return cap, every[:sh.batch_index()].sum(0), experts, every.sum(0)

    def aux_loss(probs, total):
        mean_prob = (sh.reduce_batch(probs.sum(0)) / T if split
                     else probs.mean(dim=0))
        return _aux_loss(cfg, mean_prob, total, T)

    return _experts_site(cfg, p, xn, with_aux, lambda w: w, queue, aux_loss)


def _moe_ffn_local_sharded(cfg: ModelConfig, p, xn, with_aux: bool):
    """The local dispatch of a sharded step, one site on the local shards,
    following JAX's ``moe_ffn_local`` (its shard_map) step for step: xn
    [B, S, h] (split over the batch axes where B divides them, else whole
    on every rank) -> (y, a partial sum over "model"; aux, replicated, or
    None when ``with_aux`` is False).

      * Tokens stay on their data shard: each rank routes its own b·S
        tokens against ``moe_capacity(b·S)``, with no collective, so its
        drops are those of JAX's shard (and of ``moe_ffn_local`` on a
        ``core.comm.VirtualMesh``).
      * The experts run split on f over "model" (JAX's in_specs).  Stacks
        stored on the expert axis (E divides "model") are redistributed
        to f inside the step, one all-to-all over "model" a stack, as XLA
        does at the shard_map boundary; stacks stored on f are used as
        they are.  Under ``moe_fsdp`` (the stacks' h split over "data")
        each stack is then all-gathered over "data", JAX's three
        ``all_gather(..., tiled=True)``; where the batch is split over
        "data" the backward reduce-scatters the data shards' gradients,
        where it is not each shard keeps its block of the whole gradient
        it computed (``sharding.gather_data``).
      * The routed experts' partial and the shared experts' f block make
        one partial sum over "model", closed by the layer's one
        all-reduce (``blocks.close_sharded``: JAX's ``psum``).
      * The aux loss is the shard's own; where the batch is split, it is
        all-reduced over the batch axes and divided by dp (JAX's
        ``pmean``).
      * In the backward, the tokens' and the routing weights' gradients
        are all-reduced over "model" (``copy_to_model``), so the router's
        gradient is whole on every model rank."""
    if cfg.moe.expert_d_ff % sh.axis_size("model"):
        raise NotImplementedError("the local dispatch needs the experts' "
                                  "d_ff to divide the model axis")
    # one layer's stacks: on E (redistributed to f below), or on f
    dims = tuple(sh.model_dim(p[n]) for n in _STACKS)
    if dims not in ((0, 0, 0), (2, 1, 2)):
        raise NotImplementedError(f"expert stacks split on dims {dims}")
    fsdp = tuple(sh.split_over_batch(p[n]) for n in _STACKS)
    split = sh.batch_sharded(xn)
    dp = math.prod(sh.axis_size(a) for a in ("pod", "data"))

    def prepare(w):
        for n, gather in zip(_STACKS, fsdp):
            if dims[0] == 0:
                w[n] = sh.experts_to_f(w[n], _F_DIM[n])
            if gather:
                w[n] = sh.gather_data(w[n], _H_DIM[n], split)
        return w

    def queue(top_i):
        return moe_capacity(top_i.shape[0], cfg), None, None, None

    def aux_loss(probs, counts):
        aux = _aux_loss(cfg, probs.mean(dim=0), counts, probs.shape[0])
        if split:
            aux = (sh.reduce_batch(aux.reshape(1)) / dp).reshape(())
        return aux

    return _experts_site(cfg, p, xn, with_aux, prepare, queue, aux_loss)


def _experts_site(cfg: ModelConfig, p, xn, with_aux: bool, prepare, queue,
                  aux_loss):
    """The routed and shared experts as one site under ``local_site``, the
    part both sharded dispatches share -> (y, a partial sum over "model";
    aux, replicated, or None when ``with_aux`` is False).  On the local
    blocks, ``prepare(w)`` readies the layer's weights (a dict by name)
    for the experts; the tokens are routed, ``queue(top_i)`` gives
    ``_fill``'s capacity, queue places ahead and expert range, and the
    experts' counts the aux loss takes (None: the shard's own);
    ``aux_loss(probs, counts)`` is the layer's aux loss.  The shared
    experts' f block is added to the routed partial."""
    from torch.distributed.tensor import Replicate
    h = cfg.d_model
    shared = tuple(n for n in ("sw1", "sw2", "sw3") if n in p)
    if not all(sh.model_sharded(p[n]) for n in shared):
        raise NotImplementedError("a sharded MoE needs the shared experts' "
                                  "d_ff to divide the model axis")
    names = ("router",) + _STACKS + shared

    def local(xn, *ws):
        w = prepare(dict(zip(names, ws)))
        xf = xn.reshape(-1, h)
        top_p, top_i, probs = _routed(cfg, w["router"], xf)
        cap, before, experts, total = queue(top_i)
        xc = sh.copy_to_model(xf)
        plan, counts = _fill(cfg, xc, sh.copy_to_model(top_p), top_i, cap,
                             before, experts)
        y = _experts(cfg, w, plan)
        if shared:
            y = y + mlp_apply({"w1": w["sw1"], "w2": w["sw2"],
                               "w3": w.get("sw3")}, xc, cfg.activation)
        y = y.reshape(xn.shape)
        if not with_aux:
            return y
        return y, aux_loss(probs, counts if total is None else total)

    y_pl = sh.partial_model(xn.placements)
    out_pl = (y_pl, [Replicate()] * len(y_pl)) if with_aux else y_pl
    out = sh.local_site(local, out_pl, xn, *(p[n] for n in names),
                        weights=tuple(range(1, len(names) + 1)))
    return out if with_aux else (out, None)


def _counts(top_i, num_experts: int):
    """The pairs each expert takes among the choices top_i [T, K]: [E]."""
    return (top_i.reshape(-1)[:, None]
            == torch.arange(num_experts, device=top_i.device)).sum(0)
