"""Collectives of a sharded step, read off the ops it issues.

Counterpart of ``repro.core.hlo_comm``, which walks the partitioned HLO
of a compiled step.  The port's sharded step (DTensors on a
``torch.distributed`` ``DeviceMesh``, ``runtime.sharding``) issues its
collectives as ``_c10d_functional`` ops, and ``record`` runs it under a
``TorchDispatchMode`` that logs each one: its kind, its message bytes
(the result side, as ``hlo_comm``: an all-reduce's tensor, an
all-gather's gathered tensor, a reduce-scatter's output) and its group
size, read from the op's process group.  ``CommDebugMode`` counts kinds
only.  The step runs on meta tensors over the "fake" process group (a
dry run: nothing moves, nothing is allocated) or on real ones (gloo,
NCCL); the log is the same.  A DTensor op is left to DTensor's dispatch
(the mode returns ``NotImplemented``, as ``CommDebugMode`` does), so the
log holds the collectives of the rank's local program, forward and
backward alike.

Records are ``HLOCollective`` rows, one per collective executed (no
loops to expand: the layer loop runs in Python, so a row has no count),
and ``summarize``
aggregates them by kind as ``hlo_comm.summarize`` does.  ``WIRE_FACTORS``
is ``hlo_comm``'s table of wire bytes per message byte; ``core.roofline``
reads it from here.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import defaultdict
from typing import Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# wire bytes per message byte at group size d (``hlo_comm``'s factors:
# all-reduce 2(d-1)/d, all-gather and all-to-all (d-1)/d of the gathered
# side, reduce-scatter d-1 of its output, collective-permute and a send 1)
WIRE_FACTORS = {
    "allreduce": lambda d: 2.0 * (d - 1) / d,
    "allgather": lambda d: (d - 1) / d,
    "alltoall": lambda d: (d - 1) / d,
    "reducescatter": lambda d: float(d - 1),
}


def wire_factor(kind: str, d: int) -> float:
    return WIRE_FACTORS.get(kind, lambda d: 1.0)(max(int(d), 1))


# ``_c10d_functional`` op -> (kind, position of its group-name argument)
_OPS = {
    "all_reduce": ("allreduce", 2),
    "all_reduce_": ("allreduce", 2),
    "all_reduce_coalesced": ("allreduce", 2),
    "all_reduce_coalesced_": ("allreduce", 2),
    "all_gather_into_tensor": ("allgather", 2),
    "all_gather_into_tensor_out": ("allgather", 2),
    "all_gather_into_tensor_coalesced": ("allgather", 2),
    "reduce_scatter_tensor": ("reducescatter", 3),
    "reduce_scatter_tensor_coalesced": ("reducescatter", 3),
    "all_to_all_single": ("alltoall", 3),
    "broadcast": ("broadcast", 2),
    "broadcast_": ("broadcast", 2),
}


@dataclasses.dataclass
class HLOCollective:
    """One collective: ``hlo_comm.HLOCollective``'s fields."""

    kind: str
    out_bytes: int               # bytes of one call's result side
    group_size: int              # participants d
    op_name: str = ""

    @property
    def wire_bytes(self) -> float:
        return self.out_bytes * wire_factor(self.kind, self.group_size)


@functools.lru_cache(maxsize=None)
def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.log: List[HLOCollective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, _dtensor()) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if func.namespace == "_c10d_functional":
            row = _OPS.get(func.overloadpacket.__name__)
            if row is not None:
                kind, at = row
                nbytes = sum(t.numel() * t.element_size()
                             for t in tree_flatten(out)[0]
                             if isinstance(t, torch.Tensor))
                self.log.append(HLOCollective(
                    kind, nbytes, _group_size(args[at]),
                    func.overloadpacket.__name__))
        return out


def record(fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, the collectives it issued, in order)."""
    rec = _Recorder()
    with rec:
        out = fn(*args, **kwargs)
    return out, rec.log


def summarize(colls: Iterable[HLOCollective]) -> Dict[str, dict]:
    """By kind: calls, message bytes, wire bytes (``hlo_comm``'s)."""
    agg: Dict[str, dict] = defaultdict(lambda: {"count": 0, "msg_bytes": 0,
                                                "wire_bytes": 0.0})
    for c in colls:
        a = agg[c.kind]
        a["count"] += 1
        a["msg_bytes"] += c.out_bytes
        a["wire_bytes"] += c.wire_bytes
    return dict(agg)


def trivial(colls: Iterable[HLOCollective]) -> List[HLOCollective]:
    """The records over groups of one device (they move nothing)."""
    return [c for c in colls if c.group_size <= 1]


# ---------------------------------------------------------------------------
# the closed forms a sharded step is held to
# ---------------------------------------------------------------------------


def _rows(mesh_shape: dict, B: int) -> int:
    """b: the rows a data shard holds (B when the batch does not divide
    the batch axes and is replicated, as ``sharding.data_spec``)."""
    dp = 1
    for a in ("pod", "data"):
        dp *= mesh_shape.get(a, 1)
    return B // dp if (B % dp == 0 and B >= dp) else B


def _add(out, kind, n, msg):
    if n and msg:
        row = out.setdefault(kind, {"count": 0, "msg_bytes": 0})
        row["count"] += n
        row["msg_bytes"] += n * msg


def _attention_heads(cfg) -> int:
    """The query heads of a layer's attention (hymba's n_attn of its
    heads; the config's elsewhere)."""
    if cfg.family != "hybrid":
        return cfg.num_heads
    from repro_torch.models.hybrid import head_split
    return head_split(cfg)[0]


def closed_form(cfg, mode: str, mesh_shape: dict, B: int, S: int,
                cache_width: int = None, param_bytes=None,
                remat: str = "none") -> Dict[str, dict]:
    """{kind: {count, msg_bytes}} of one sharded step of ``cfg`` on a mesh
    of ``mesh_shape`` ({axis: size}), B the global batch and S the
    sequence (the vlm's prefix included; 1 a decode step's token).  m is
    the "model" axis, dp the batch axes' devices, b = B / dp, e the type's
    bytes, L the layers, row = [b, S, h]·e; a collective over one device
    is none, and one over the batch axes runs only where the batch is
    split over them.  ``param_bytes``' keys are leaf names, suffixed
    ":data" where the leaf is split over a batch axis (``moe_fsdp``'s
    expert stacks) and then ":model" where it is split over "model"
    (``local_param_bytes``).

      * "prefill" (and a forward): the embedding's all-reduce of row (none
        for the encoder; the vlm's over its text tokens, [b, S - P, h]·e,
        before the P prefix embeddings join), then per layer:
        - dense, encoder, vlm: 2 all-reduces of row (the attention's and
          the MLP's row-parallel outputs, each at the norm after it);
        - moe, GSPMD dispatch: the same 2, and the experts' counts
          all-gathered over the batch axes, [dp·E] int32 (the capacity
          cut is global);
        - moe, local dispatch (``moe_dispatch`` "local" on a mesh with a
          "model" axis): the same 2 and no counts gather.  With stack =
          E·h·f/m·e (one layer's expert stack split on f, f its d_ff) and
          d the "data" axis: where the stacks are stored on the expert
          axis (``sharding.expert_stack_layout``), 3 all-to-alls over
          "model" that redistribute them to f, of stack (stack / d under
          ``moe_fsdp``); under ``moe_fsdp`` (d > 1), 3 all-gathers over
          "data" of stack, whether or not the batch is split;
        - ssm: 1 all-reduce of row (the time mix), and the channel mix's
          reduce-scatter of its value ([b, S, h/m]·e) and all-gather of
          its output (row);
        - hybrid: 2 all-reduces of row (the attention branch before its
          norm, the MLP) and, where d_inner divides m, 1 more (the mamba
          branch) and B and C side by side, [b, S, 2N]·e; where in_proj
          divides m, the all-gather of xz, [b, S, 2·di]·e;
        - the attention (not ssm): where the KV heads do not divide m, 2
          all-gathers of K and V, [b, S, Hkv·D]·e, and where the query
          heads (Hq: hymba's n_attn) do not either, 1 more of q,
          [b, S, Hq·D]·e.  No logits gather.
      * "decode": the same at S = 1; the argmax's two all-gathers over
        "model" ([b, m] of the logits' type and of int32); on a
        sequence-parallel cache (``blocks.kv_layout`` "seq") each layer's
        q, k and v all-gathers and the partial softmax's MAX ([b, Hq] f32)
        and SUM ([b, Hq, D + 1] f32) all-reduces; on a replicated one the
        three all-gathers.
      * "train": the forward's collectives, and the MoE layer's sum of the
        router's probabilities over the batch axes ([E] f32, the aux
        loss's mean; on the local dispatch instead the aux loss's own f32
        all-reduce over them, 4 bytes, its ``pmean``); the local
        dispatch's 3 inverse all-to-alls a layer where the stacks are
        stored on E and, under ``moe_fsdp`` where the batch is split, 3
        reduce-scatters over "data" of each gathered stack's gradient,
        stack / d (where it is not split, every data shard computes the
        whole gradient and keeps its block: no collective); the
        cross-entropy's three all-reduces over "model"
        ([b, S'] f32, S' the positions with a target) and its scalar over
        the batch axes; the backward's all-reduce of each
        column-parallel input's gradient: per layer q, k, v and the MLP's
        up projections (dense, hybrid), q, k, v, the experts' tokens (row)
        and routing weights ([b·S, K] f32) (moe), the time mix's four
        mixes (row) and its decay LoRA's [b, S, 64]·e and the channel
        mix's two (ssm), hymba's xn where in_proj divides m; and the
        head's; a reduce-scatter of each forward all-gather's gradient
        whose users are split (the attention's, hymba's xz where d_inner
        divides m: [b, S, 2·di/m]·e) and an all-gather of each
        reduce-scatter's (ssm: row); hymba's B and C again (their users
        are split); the ssm layer's replicated wb, w0 and ln_x, read in
        column blocks, all-reduce their gradients over "model" ([64, h]·e,
        [h]·4, [h]·e); one all-reduce over the batch axes of each
        parameter's local gradient (``param_bytes``: its local bytes; the
        tied embedding twice, once a use), but none of a ":data" leaf's
        on a mesh without "pod" (its reduce-scatter has summed it); and
        one scalar all-reduce of the squared norm over "model" for each
        parameter split over it (keys ending in ":model") and over the
        batch axes for each ":data" leaf.  Under ``remat``
        ("full" or "dots") the backward recomputes each layer, and with
        it the layer's forward collectives but layer 0's input, which
        arrives reduced."""
    m = mesh_shape.get("model", 1)
    dp = 1
    for a in ("pod", "data"):
        dp *= mesh_shape.get(a, 1)
    b = _rows(mesh_shape, B)
    batch = dp > 1 and b != B
    fam = cfg.family
    L, h, D, N = cfg.num_layers, cfg.d_model, cfg.head_dim, 0
    Hq, Hkv = _attention_heads(cfg), cfg.num_kv_heads
    e = 4 if cfg.dtype == "float32" else 2
    decode = mode == "decode"
    S_ = 1 if decode else S
    row = b * S_ * h * e
    if fam == "hybrid":
        from repro_torch.models.hybrid import head_split
        di, N = head_split(cfg)[1] * D, cfg.ssm.state_size
        in_split, di_split = (2 * di) % m == 0, di % m == 0
    local = fam == "moe" and cfg.moe_dispatch == "local" and \
        "model" in mesh_shape
    if local:
        from repro_torch.runtime.sharding import expert_stack_layout
        E, d = cfg.moe.num_experts, mesh_shape.get("data", 1)
        on_e, fsdp = expert_stack_layout(cfg, m, d)
        stack = E * h * cfg.moe.expert_d_ff // m * e   # a stack, f split
        moved = stack // (d if fsdp else 1)
    out: Dict[str, dict] = {}
    if m == 1 and not batch and not (local and fsdp):
        return out
    M = 1 if m > 1 else 0          # a collective over "model" runs
    # one layer's forward, and whether its output is a partial sum (the
    # next norm site all-reduces it)
    layer: List[tuple] = []        # (kind, message bytes) a layer
    partial_out = fam != "ssm"
    if fam == "ssm":
        layer += [("allreduce", row)] * M
        layer += [("reducescatter", row // m)] * M
        layer += [("allgather", row)] * M
    else:
        layer += [("allreduce", row)] * M     # the attention's output
    if local:
        layer += [("alltoall", moved)] * (3 if on_e else 0)
        layer += [("allgather", stack)] * (3 if fsdp else 0)
        if mode == "train" and batch:
            layer.append(("allreduce", 4))
    elif fam == "moe" and batch:
        layer.append(("allgather", dp * cfg.moe.num_experts * 4))
        if mode == "train":
            layer.append(("allreduce", cfg.moe.num_experts * 4))
    if fam == "hybrid" and m > 1:
        if di_split:
            layer.append(("allreduce", row))      # the mamba branch
            layer.append(("allreduce", b * S_ * 2 * N * e))
        if in_split:
            layer.append(("allgather", b * S_ * 2 * di * e))
    gathers = []            # the attention's forward all-gathers' widths
    if fam != "ssm" and m > 1:
        kv_split = (Hkv * D) % m == 0
        layout = ("heads" if Hkv % m == 0 else "gather" if not decode else
                  "seq" if cache_width % m == 0 else "replicated")
        if decode and layout != "heads":
            gathers = [Hq * D] + ([Hkv * D] * 2 if kv_split else [])
        elif layout != "heads":
            gathers = ([Hkv * D] * 2 if kv_split else []) + \
                ([Hq * D] if Hq % m else [])
        for width in gathers:
            layer.append(("allgather", b * S_ * width * e))
        if layout == "seq":
            layer.append(("allreduce", b * Hq * 4))
            layer.append(("allreduce", b * Hq * (D + 1) * 4))
    for kind, nbytes in layer:
        _add(out, kind, L, nbytes)
    # the layers' partial outputs: at the next layer's ln1, the last at
    # the final norm
    _add(out, "allreduce", L * M if partial_out else 0, row)
    embed = 0 if fam == "encoder" else M
    prefix = cfg.num_prefix_tokens if (fam == "vlm" and not decode) else 0
    _add(out, "allreduce", embed, b * (S_ - prefix) * h * e)
    if decode:
        _add(out, "allgather", M, b * m * e)
        _add(out, "allgather", M, b * m * 4)
        return out
    if mode != "train":
        return out
    if m > 1:
        s_ce = S if fam == "encoder" else (
            S - cfg.num_prefix_tokens - 1 if fam == "vlm" else S - 1)
        _add(out, "allreduce", 3, b * s_ce * 4)
        ups = 2 if cfg.activation in ("swiglu", "geglu") else 1
        copies = {"ssm": 6, "moe": 4,
                  "hybrid": 3 + ups + (1 if in_split else 0)
                  if fam == "hybrid" else 0}.get(fam, 3 + ups)
        _add(out, "allreduce", L * copies + 1, row)
        for width in gathers:
            _add(out, "reducescatter", L, b * S * width // m * e)
        if fam == "moe":
            _add(out, "allreduce", L, b * S * cfg.moe.top_k * 4)
        if fam == "ssm":
            from repro_torch.models.ssm import DECAY_LORA
            _add(out, "allreduce", L, b * S * DECAY_LORA * e)
            _add(out, "allgather", L, row)
            for nbytes in (DECAY_LORA * h * e, h * 4, h * e):
                _add(out, "allreduce", L, nbytes)
        if fam == "hybrid" and di_split:
            _add(out, "reducescatter", L, b * S * 2 * di // m * e)
            _add(out, "allreduce", L, b * S * 2 * N * e)
    if local:      # the inverse all-to-alls, the gathers' scatters
        _add(out, "alltoall", 3 * L if on_e else 0, moved)
        _add(out, "reducescatter", 3 * L if fsdp and batch else 0,
             stack // d)
    if remat != "none":
        for kind, nbytes in layer:
            _add(out, kind, L, nbytes)
        _add(out, "allreduce", (L - 1) * M if partial_out else 0, row)
    if batch:
        _add(out, "allreduce", 1, 4)
        pod = mesh_shape.get("pod", 1) > 1
        for name, nbytes in (param_bytes or {}).items():
            if ":data" in name and not pod:
                continue
            uses = 2 if (name.startswith("embed") and cfg.tie_embeddings
                         and fam != "encoder") else 1
            _add(out, "allreduce", uses, nbytes)
    if m > 1:
        sharded = sum(1 for k in (param_bytes or {}) if k.endswith(":model"))
        _add(out, "allreduce", sharded, 4)
    _add(out, "allreduce", sum(1 for k in (param_bytes or {})
                               if ":data" in k), 4)
    return out


def local_param_bytes(params) -> Dict[str, int]:
    """{leaf name: its local bytes} of a DTensor parameter tree, the name
    suffixed with ":data" where the leaf is split over a batch axis of
    more than one device (``moe_fsdp``) and then ":model" where it is
    split over "model" (the input ``closed_form`` takes for a train
    step)."""
    from repro_torch.checkpoint.store import flatten
    from repro_torch.runtime import sharding as sh
    out = {}
    for name, p in flatten(params).items():
        local = p.to_local()
        key = name + (":data" if sh.split_over_batch(p) else "") \
            + (":model" if sh.model_sharded(p) else "")
        out[key] = local.numel() * local.element_size()
    return out


def same(summary: Dict[str, dict], form: Dict[str, dict]) -> bool:
    """Whether a ``summarize`` result equals a closed form: the same kinds,
    each with the same number of calls and message bytes."""
    if set(summary) != set(form):
        return False
    return all(summary[k]["msg_bytes"] == form[k]["msg_bytes"]
               and summary[k]["count"] == form[k]["count"] for k in form)
