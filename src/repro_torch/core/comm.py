"""The port's communication layer: collectives over virtual TP ranks, with
a log of every call.

``VirtualGroup(t)`` holds t ranks on one device.  Each collective takes
the list of the t per-rank tensors and computes on the device what the
wire would deliver; the semantics are those of the JAX package's
``lax.psum`` / ``pmax`` / ``psum_scatter(tiled)`` / ``all_gather(tiled)``
/ ``all_to_all(tiled)`` over the last axis:

  all_reduce(xs, op)   -> one tensor, what every rank holds afterwards
  reduce_scatter(xs)   -> t tensors: rank r's 1/t block of the sum
  all_gather(xs)       -> one tensor: the blocks side by side, rank order
  all_to_all(xs)       -> t tensors: rank r's input block r of every rank
  collective_permute(xs) -> t tensors: rank r's is rank r-1's (a ring step)

Reduction order: a sum runs in rank order 0, 1, ..., t-1 in the working
dtype (the inputs' dtype), one rounding per add.  An fp8 (e4m3)
reduce-scatter, which the card cannot add in its own type, adds in f32 in
rank order and rounds once to e4m3; its output is the 1-byte wire dtype.

Every call is logged as a ``CommRecord`` (kind, phase, per-rank shape,
bytes per element, t): the port's counterpart of what
``repro.core.hlo_comm`` reads off compiled HLO.  ``summary()`` folds the
log into ``commodel.CommOp`` rows, so a run's collectives compare with
``commodel.comm_ops_for(..., gather_mode="allgather", quant=...)``.  A
group of one rank moves nothing and logs nothing (the JAX engine drops
the degenerate mesh axis).

A (t, c) mesh — t TP ranks for each of c context-parallel (CP) sequence
shards — is a TP group and a CP group sharing one log
(``VirtualGroup(c, log=tp.log)``).  The log keeps the SPMD program's
count, one collective per rank and site: the c shards' TP collectives at
one site are one all-reduce of one shard's message, and the t ranks' ring
steps one collective-permute of one rank's block.  The calls after the
first at a site run under ``muted()``, which moves the data and logs
nothing.

``VirtualMesh`` is the counterpart of a JAX ``Mesh`` of named axes, such
as (data, model) or (pod, data, model): a ``shape`` dict in axis order,
and one ``VirtualGroup`` per axis (or per tuple of axes, ``group``), all
sharing one log under the same conventions.  The expert-TP MoE path
(``models.moe.moe_ffn_local``) runs on it.

A ``torch.distributed``/NCCL group with the same interface, one rank per
card, waits for a four-card cell (ROADMAP).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.core.commodel import CommOp


@dataclasses.dataclass(frozen=True)
class CommRecord:
    """One logged collective call."""

    kind: str                    # allreduce|reducescatter|allgather|
                                 # alltoall|collectivepermute
    phase: str                   # "prefill" | "decode"
    shape: Tuple[int, ...]       # one rank's input, in logical elements
    itemsize: float              # bytes per logical element on the wire
    t: int


def _message_shape(rec: CommRecord) -> Tuple[int, int]:
    """commodel's per-call message shape: (rows, width), where width is the
    input's last axis, or the gathered axis for an all-gather."""
    rows = math.prod(rec.shape[:-1])
    width = rec.shape[-1] * (rec.t if rec.kind == "allgather" else 1)
    return rows, width


def op_key(op: CommOp) -> tuple:
    """(collective, phase, elements, workers, bytes per element) of a row.
    Shapes compare by element count: commodel writes the logits gather
    flat, (batch * vocab,), and the other messages as (rows, width)."""
    return (op.collective, op.phase, op.elements, op.workers,
            float(op.dtype_bytes))


def fold(ops: Sequence[CommOp]) -> Dict[tuple, int]:
    """Call counts by ``op_key``: two lists of rows describe the same
    collectives exactly when their folds are equal."""
    out: Dict[tuple, int] = collections.Counter()
    for o in ops:
        out[op_key(o)] += o.count
    return dict(out)


def counts_by_collective(ops: Sequence[CommOp]) -> Dict[str, int]:
    out: Dict[str, int] = collections.Counter()
    for o in ops:
        out[o.collective] += o.count
    return dict(out)


def summarize(log: Sequence[CommRecord], phase: str = None) -> List[CommOp]:
    """A log (of one ``phase``, or all of it) folded into ``CommOp`` rows,
    one per (kind, phase, message shape, bytes per element), in first-seen
    order."""
    rows: Dict[tuple, int] = {}
    for rec in log:
        if phase not in (None, rec.phase):
            continue
        size = rec.itemsize
        key = (rec.kind, rec.phase, _message_shape(rec), rec.t,
               int(size) if float(size).is_integer() else size)
        rows[key] = rows.get(key, 0) + 1
    return [CommOp(kind, phase, n, shape, t, size)
            for (kind, phase, shape, t, size), n in rows.items()]


class VirtualGroup:
    """t virtual ranks on one device, with a log of every collective
    (``log``: a list shared with another axis of the same mesh)."""

    def __init__(self, t: int, log: List[CommRecord] = None):
        if t < 1:
            raise ValueError(f"t must be >= 1, got {t}")
        self.t = int(t)
        self.log: List[CommRecord] = [] if log is None else log
        self._phase = "prefill"
        self._muted = False

    @contextlib.contextmanager
    def phase(self, name: str):
        """Log the collectives issued inside the block under ``name``."""
        prev, self._phase = self._phase, name
        try:
            yield self
        finally:
            self._phase = prev

    @contextlib.contextmanager
    def muted(self, on: bool = True):
        """Run the block's collectives without logging them (when ``on``):
        the later shards' or ranks' calls at a site whose one collective
        the first call logged."""
        prev, self._muted = self._muted, self._muted or bool(on)
        try:
            yield self
        finally:
            self._muted = prev

    # -- the log -------------------------------------------------------------
    def _record(self, kind: str, xs, values_per_item: int = 1,
                axis: int = -1) -> None:
        if self._muted:
            return
        x = xs[0]
        dims = list(x.shape)
        dims.append(dims.pop(axis))         # the split axis last
        shape = (*dims[:-1], dims[-1] * values_per_item)
        itemsize = x.element_size() / values_per_item
        self.log.append(CommRecord(kind, self._phase, tuple(shape),
                                   itemsize, self.t))

    def _check(self, xs, kind: str) -> None:
        if len(xs) != self.t:
            raise ValueError(f"{kind}: {len(xs)} tensors for t={self.t} ranks")
        first = xs[0]
        for x in xs[1:]:
            if x.shape != first.shape or x.dtype != first.dtype:
                raise ValueError(
                    f"{kind}: rank tensors differ ({tuple(x.shape)} "
                    f"{x.dtype} vs {tuple(first.shape)} {first.dtype})")

    def summary(self, phase: str = None) -> List[CommOp]:
        return summarize(self.log, phase)

    # -- collectives ---------------------------------------------------------
    def all_reduce(self, xs, op: str = "sum"):
        """psum (``op="sum"``) or pmax (``op="max"``) of the rank tensors,
        in rank order; NaN propagates through the max."""
        if self.t == 1:
            return xs[0]
        self._check(xs, "all_reduce")
        self._record("allreduce", xs)
        if op == "sum":
            out = xs[0]
            for x in xs[1:]:
                out = out + x
            return out
        if op == "max":
            out = xs[0]
            for x in xs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(f"all_reduce op must be 'sum' or 'max', got {op!r}")

    def reduce_scatter(self, xs):
        """psum_scatter(tiled) over the last axis: rank r gets block r of
        the sum.  An fp8 payload adds in f32 and rounds once to e4m3."""
        if self.t == 1:
            return [xs[0]]
        self._check(xs, "reduce_scatter")
        h = xs[0].shape[-1]
        if h % self.t:
            raise ValueError(f"reduce_scatter: last axis {h} does not "
                             f"divide over t={self.t}")
        self._record("reducescatter", xs)
        if xs[0].dtype == torch.float8_e4m3fn:
            total = xs[0].float()
            for x in xs[1:]:
                total = total + x.float()
            total = total.to(torch.float8_e4m3fn)
        else:
            total = xs[0]
            for x in xs[1:]:
                total = total + x
        return [b.contiguous() for b in total.chunk(self.t, dim=-1)]

    def all_gather(self, xs, values_per_item: int = 1, axis: int = -1):
        """all_gather(tiled) over ``axis`` (the last by default), logged
        with that axis last.  ``values_per_item`` = 2 logs a packed int4
        payload at half a byte per value."""
        if self.t == 1:
            return xs[0]
        self._check(xs, "all_gather")
        self._record("allgather", xs, values_per_item, axis)
        return torch.cat(list(xs), dim=axis)

    def all_to_all(self, xs, values_per_item: int = 1):
        """all_to_all(tiled), split and concatenated on the last axis: rank
        r receives block r of every rank's input, in rank order."""
        if self.t == 1:
            return [xs[0]]
        self._check(xs, "all_to_all")
        h = xs[0].shape[-1]
        if h % self.t:
            raise ValueError(f"all_to_all: last axis {h} does not divide "
                             f"over t={self.t}")
        self._record("alltoall", xs, values_per_item)
        blocks = [x.chunk(self.t, dim=-1) for x in xs]
        return [torch.cat([blocks[src][dst] for src in range(self.t)], dim=-1)
                for dst in range(self.t)]

    def collective_permute(self, xs, out=None):
        """One ring step (``ppermute`` to rank r + 1 mod t): rank r receives
        rank r - 1's tensor, as a copy — into ``out[r]`` when given (the
        receiver's buffer).  Returns the t received tensors."""
        if self.t == 1:
            return [xs[0]]
        self._check(xs, "collective_permute")
        self._record("collectivepermute", xs)
        if out is None:
            return [xs[r - 1].clone() for r in range(self.t)]
        for r, dst in enumerate(out):
            dst.copy_(xs[r - 1])
        return list(out)


class VirtualMesh:
    """A mesh of named axes on one device: ``shape`` maps each axis name
    to its size, in axis order (JAX's ``Mesh.shape``); ``group(axes)`` is
    the ``VirtualGroup`` over one axis or the product of several, and
    every group logs into ``log``."""

    def __init__(self, shape, axes):
        shape, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} does not match axes {axes}")
        self.shape = dict(zip(axes, shape))
        self.log: List[CommRecord] = []
        self._groups: Dict[tuple, VirtualGroup] = {}

    def group(self, axes) -> VirtualGroup:
        """The group over ``axes`` (a name or a tuple of names): one rank
        per point of those axes, as a collective over them spans."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes not in self._groups:
            self._groups[axes] = VirtualGroup(
                math.prod(self.shape[a] for a in axes), log=self.log)
        return self._groups[axes]

    def summary(self) -> List[CommOp]:
        return summarize(self.log)
