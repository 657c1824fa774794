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
# the closed forms a sharded step of the dense-block families is held to
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


def closed_form(cfg, mode: str, mesh_shape: dict, B: int, S: int,
                cache_width: int = None, param_bytes=None,
                remat: str = "none") -> Dict[str, dict]:
    """{kind: {count, msg_bytes}} of one sharded step of a dense, encoder
    or vlm config on a mesh of ``mesh_shape`` ({axis: size}), B the global
    batch and S the sequence (the vlm's prefix included; 1 a decode
    step's token).  m is the "model" axis, b = B / dp, e the type's bytes,
    L the layers; a collective over one device is none.

      * "prefill" (and a forward): 2L + 1 all-reduces of [b, S, h]·e (the
        embedding's and each row-parallel output's; 2L for the encoder,
        which has no embedding; the vlm's embedding all-reduces its text
        tokens, [b, S - P, h]·e, before the P prefix embeddings join);
        where the KV heads do not divide m, 2L all-gathers of K and V,
        [b, S, Hkv·D]·e, and where the query heads do not either, L more
        of q, [b, S, Hq·D]·e.  No logits gather.
      * "decode": the same at S = 1; the argmax's two all-gathers over
        "model" ([b, m] of the logits' type and of int32); on a
        sequence-parallel cache (``blocks.kv_layout`` "seq") each layer's
        q, k and v all-gathers and the partial softmax's MAX ([b, Hq] f32)
        and SUM ([b, Hq, D + 1] f32) all-reduces; on a replicated one the
        three all-gathers.
      * "train": the forward's collectives; the cross-entropy's three
        all-reduces over "model" ([b, S'] f32, S' the positions with a
        target) and its scalar over the batch axes; the backward's
        all-reduce of each column-parallel input's gradient (q, k, v and
        the MLP's up projections a layer, and the head), [b, S, h]·e, and
        a reduce-scatter of each forward all-gather's gradient; one
        all-reduce over the batch axes of each parameter's local gradient
        (``param_bytes``: its local bytes; the tied embedding twice, once
        a use) and one scalar all-reduce over "model" of the squared norm
        of each parameter split over it (``param_bytes``'s keys ending in
        ":model").  Under ``remat`` ("full" or "dots") the backward
        recomputes each layer, and with it the layer's forward
        collectives: 2L - 1 more all-reduces of [b, S, h]·e (layer 0's
        input arrives reduced) and the gathers again."""
    m = mesh_shape.get("model", 1)
    dp = 1
    for a in ("pod", "data"):
        dp *= mesh_shape.get(a, 1)
    b = _rows(mesh_shape, B)
    batch_split = b != B or dp == 1
    L, h, D = cfg.num_layers, cfg.d_model, cfg.head_dim
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    e = 4 if cfg.dtype == "float32" else 2
    out: Dict[str, dict] = {}
    if m == 1 and (mode != "train" or dp == 1):
        return out
    embed = 0 if cfg.family == "encoder" else 1
    S_ = 1 if mode == "decode" else S
    kv_split = (Hkv * D) % m == 0
    if m > 1:
        _add(out, "allreduce", 2 * L, b * S_ * h * e)
        prefix = cfg.num_prefix_tokens if (cfg.family == "vlm"
                                           and mode != "decode") else 0
        _add(out, "allreduce", embed, b * (S_ - prefix) * h * e)
    if mode == "decode":
        if m > 1:
            _add(out, "allgather", 1, b * m * e)
            _add(out, "allgather", 1, b * m * 4)
        layout = ("heads" if Hkv % m == 0 else
                  "seq" if cache_width % m == 0 else "replicated")
        if layout != "heads":
            _add(out, "allgather", L, b * Hq * D * e)
            if kv_split:
                _add(out, "allgather", 2 * L, b * Hkv * D * e)
        if layout == "seq":
            _add(out, "allreduce", L, b * Hq * 4)
            _add(out, "allreduce", L, b * Hq * (D + 1) * 4)
        return out
    gathers = []
    if m > 1 and Hkv % m:
        if kv_split:
            gathers += [Hkv * D] * 2
        if Hq % m:
            gathers.append(Hq * D)
    for width in gathers:
        _add(out, "allgather", L, b * S * width * e)
    if mode != "train":
        return out
    if m > 1:
        s_ce = S if cfg.family == "encoder" else (
            S - cfg.num_prefix_tokens - 1 if cfg.family == "vlm" else S - 1)
        _add(out, "allreduce", 3, b * s_ce * 4)
        ups = 2 if cfg.activation in ("swiglu", "geglu") else 1
        _add(out, "allreduce", L * (3 + ups) + 1, b * S * h * e)
        for width in gathers:
            _add(out, "reducescatter", L, b * S * width // m * e)
        if remat != "none":
            _add(out, "allreduce", 2 * L - 1, b * S * h * e)
            for width in gathers:
                _add(out, "allgather", L, b * S * width * e)
    if dp > 1 and batch_split:
        _add(out, "allreduce", 1, 4)
        for name, nbytes in (param_bytes or {}).items():
            uses = 2 if (name.startswith("embed") and cfg.tie_embeddings
                         and cfg.family != "encoder") else 1
            _add(out, "allreduce", uses, nbytes)
    if m > 1:
        sharded = sum(1 for k in (param_bytes or {}) if k.endswith(":model"))
        _add(out, "allreduce", sharded, 4)
    return out


def local_param_bytes(params) -> Dict[str, int]:
    """{leaf name: its local bytes} of a DTensor parameter tree, the name
    suffixed with ":model" where the leaf is split over "model" (the input
    ``closed_form`` takes for a train step)."""
    from repro_torch.checkpoint.store import flatten
    from repro_torch.runtime import sharding as sh
    out = {}
    for name, p in flatten(params).items():
        local = p.to_local()
        key = name + (":model" if sh.model_sharded(p) else "")
        out[key] = local.numel() * local.element_size()
    return out


def same(summary: Dict[str, dict], form: Dict[str, dict]) -> bool:
    """Whether a ``summarize`` result equals a closed form: the same kinds,
    each with the same number of calls and message bytes."""
    if set(summary) != set(form):
        return False
    return all(summary[k]["msg_bytes"] == form[k]["msg_bytes"]
               and summary[k]["count"] == form[k]["count"] for k in form)
