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

``DistGroup`` is the same interface on real ranks: one process per rank
of a ``torch.distributed`` group (NCCL on the card, gloo on the CPU).  A
process holds one rank (``local_ranks`` is ``(rank,)``, where a
``VirtualGroup``'s is ``range(t)``), so every collective takes a list of
one tensor and returns what this rank holds, in the shape a
``VirtualGroup`` returns for one rank.  Every process logs every call, so
rank 0's log equals the virtual group's record for record.
``dist_groups(t, p, c=c)`` builds a world of t·c·p processes into p
stages of t·c ranks, stage-major, each stage a (t, c) plane in the JAX
package's order (``devices[s·t·c:(s+1)·t·c].reshape(t, c)``): a TP group
of the t ranks that share a CP index and a CP group of the c ranks that
share a TP index, the CP group logging into the TP group's log, as on a
virtual (t, c) mesh.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

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
        self.local_ranks = range(self.t)
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
        if len(xs) != len(self.local_ranks):
            raise ValueError(f"{kind}: {len(xs)} tensors for "
                             f"{len(self.local_ranks)} local ranks")
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


# the collectives' current names, where this torch has them
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _wire(x):
    """A 1-byte payload as uint8 for the collectives that only move it
    (fp8 has no type on every backend); others as they are."""
    return x.view(torch.uint8) if x.element_size() == 1 else x


class DistGroup(VirtualGroup):
    """Rank ``rank`` of a TP group of t processes (``torch.distributed``
    group ``pg`` over the global ``ranks``; NCCL on the card, gloo on the
    CPU), with the log and the interface of ``VirtualGroup``.

    Each collective takes [this rank's tensor] and returns what this rank
    holds.  Semantics against the virtual group:

      * a float all-reduce is the backend's ``all_reduce``: its sum order
        is NCCL's (or gloo's), not rank order, so the values match the
        virtual group's within float tolerance, not bit for bit; every
        rank holds the same result;
      * the int8 reduce-scatter is the backend's ``reduce_scatter`` of the
        last-axis blocks (laid along dim 0, which the backend splits): the
        sum is exact under ``collective_qmax``'s headroom, so it is the
        virtual one bit for bit;
      * the fp8 reduce-scatter keeps "adds in f32 in rank order and rounds
        once to e4m3", which no backend's e4m3 sum does: an
        ``all_to_all_single`` of the 1-byte blocks (the bytes a
        reduce-scatter puts on the wire), then the f32 sum in rank order
        and one rounding here, logged as the schedule's
        ``reducescatter``;
      * all-gather, all-to-all (the int4 path's uint8) and the ring step
        (``batch_isend_irecv``) move bytes and are exact."""

    def __init__(self, t: int, rank: int, pg=None, ranks=None,
                 log: List[CommRecord] = None):
        super().__init__(t, log)
        if not 0 <= rank < self.t:
            raise ValueError(f"rank {rank} outside a group of t={self.t}")
        self.rank = int(rank)
        self.local_ranks = (self.rank,)
        self.pg = pg
        self.ranks = list(range(self.t) if ranks is None else ranks)

    def _blocks(self, x):
        """[..., h] -> [t, ..., h/t]: the last-axis blocks stacked on dim
        0, contiguous."""
        h = x.shape[-1]
        if h % self.t:
            raise ValueError(f"last axis {h} does not divide over "
                             f"t={self.t}")
        return torch.stack(x.chunk(self.t, dim=-1))

    def _exchange(self, x):
        """all_to_all of the last-axis blocks: row r of the result is rank
        r's block ``self.rank``."""
        send = self._blocks(x)
        recv = torch.empty_like(_wire(send))
        dist.all_to_all_single(recv, _wire(send), group=self.pg)
        return recv.view(send.dtype)

    def all_reduce(self, xs, op: str = "sum"):
        if self.t == 1:
            return xs[0]
        self._check(xs, "all_reduce")
        if op not in ("sum", "max"):
            raise ValueError(f"all_reduce op must be 'sum' or 'max', "
                             f"got {op!r}")
        self._record("allreduce", xs)
        out = xs[0].clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=self.pg)
        return out

    def reduce_scatter(self, xs):
        if self.t == 1:
            return [xs[0]]
        self._check(xs, "reduce_scatter")
        x = xs[0]
        if x.dtype == torch.float8_e4m3fn:
            got = self._exchange(x)
            total = got[0].float()
            for b in got[1:]:
                total = total + b.float()
            out = total.to(torch.float8_e4m3fn)
        else:
            blocks = self._blocks(x)
            out = x.new_empty(blocks.shape[1:])
            _REDUCE_SCATTER(out, blocks.flatten(0, 1), op=dist.ReduceOp.SUM,
                            group=self.pg)
        self._record("reducescatter", xs)
        return [out]

    def all_gather(self, xs, values_per_item: int = 1, axis: int = -1):
        if self.t == 1:
            return xs[0]
        self._check(xs, "all_gather")
        self._record("allgather", xs, values_per_item, axis)
        x = xs[0].contiguous()
        out = x.new_empty((self.t * x.shape[0], *x.shape[1:]))
        _ALL_GATHER(_wire(out), _wire(x), group=self.pg)
        return torch.cat(out.chunk(self.t), dim=axis)

    def all_to_all(self, xs, values_per_item: int = 1):
        if self.t == 1:
            return [xs[0]]
        self._check(xs, "all_to_all")
        got = self._exchange(xs[0])
        self._record("alltoall", xs, values_per_item)
        return [torch.cat(got.unbind(0), dim=-1)]

    def collective_permute(self, xs, out=None):
        """The ring step; a receive buffer the backend cannot write in
        place (a strided view, such as the ring's block of an assembled
        [B, S, ...] tensor) takes the bytes through a contiguous copy."""
        if self.t == 1:
            return [xs[0]]
        self._check(xs, "collective_permute")
        self._record("collectivepermute", xs)
        x = xs[0].contiguous()
        dst = out[0] if out is not None and out[0].is_contiguous() \
            else torch.empty_like(x)
        nxt = self.ranks[(self.rank + 1) % self.t]
        prv = self.ranks[(self.rank - 1) % self.t]
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, _wire(x), nxt, group=self.pg),
                dist.P2POp(dist.irecv, _wire(dst), prv, group=self.pg)]):
            req.wait()
        if out is not None and dst is not out[0]:
            out[0].copy_(dst)
            dst = out[0]
        return [dst]


class RankPlace(NamedTuple):
    """Where this process sits in a world of t·c·p ranks: its TP ``group``
    (a ``DistGroup`` of the stage's t ranks at its CP index), its pipeline
    ``stage``, the global ranks of its peer on the next and the previous
    stage (the same TP and CP index; None at the ends), the device its
    tensors live on, and at c > 1 its CP group (a ``DistGroup`` of the c
    ranks at its TP index, logging into ``group.log``; None at c = 1)."""
    group: DistGroup
    stage: int
    next: Optional[int]
    prev: Optional[int]
    t: int
    p: int
    device: torch.device
    c: int = 1
    cp_group: Optional[DistGroup] = None

    @property
    def last_rank(self) -> int:
        """The first rank of the last stage: the one that broadcasts the
        next greedy token."""
        return (self.p - 1) * self.t * self.c


def init_world(device) -> torch.device:
    """Join the world ``torchrun`` describes (``env://``): NCCL, and this
    process's card ``cuda:{LOCAL_RANK}``, when ``device`` is the card;
    gloo on the CPU.  Returns the rank's device.  Raises when the card
    has no NCCL or the host fewer cards than local ranks."""
    device = torch.device(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        _check_cards(local + 1)
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method="env://")
    else:
        dist.init_process_group("gloo", init_method="env://")
    return device


def _check_cards(need: int) -> None:
    if not dist.is_nccl_available():
        raise RuntimeError("ranks on the card need NCCL, which this torch "
                           "does not have")
    if torch.cuda.device_count() < need:
        raise RuntimeError(f"{need} ranks on this host need {need} cards; "
                           f"it has {torch.cuda.device_count()}")


def dist_groups(t: int, p: int = 1, device=None, c: int = 1) -> RankPlace:
    """This process's place in a world of t·c·p ranks, stage-major: stage
    s holds the global ranks s·t·c .. (s + 1)·t·c - 1, as a (t, c) plane,
    rank = s·t·c + tp·c + cp (at c = 1, s·t + tp).  Builds every stage's
    TP groups (the t ranks of one CP index) and then its CP groups (the c
    ranks of one TP index) on every rank, in the same order
    (``new_group`` is collective).  ``device`` defaults to
    ``cuda:{LOCAL_RANK}`` under NCCL and the CPU under gloo; a device on
    the card needs NCCL and a card for every local rank.  Raises when the
    world is not t·c·p ranks."""
    if not dist.is_initialized():
        raise RuntimeError("dist_groups needs torch.distributed initialised "
                           "(init_world, or init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if t < 1 or c < 1 or p < 1 or world != t * c * p:
        raise ValueError(f"a world of {world} ranks does not hold t={t} x "
                         f"c={c} x p={p}")
    nccl = dist.get_backend() == "nccl"
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         rank)))\
            if nccl else torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda":
        if not nccl:
            raise RuntimeError(f"ranks on the card need NCCL; the world "
                               f"runs {dist.get_backend()}")
        _check_cards(int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    elif nccl:
        raise RuntimeError("an NCCL world keeps its tensors on the card, "
                           f"not on {device}")
    plane = t * c
    stage, within = divmod(rank, plane)
    tp_rank, cp_rank = divmod(within, c)

    def tp_ranks(s, j):
        return [s * plane + i * c + j for i in range(t)]

    def cp_ranks(s, i):
        return [s * plane + i * c + j for j in range(c)]

    pg = cp_pg = None
    for s in range(p):
        for j in range(c if t > 1 else 0):
            g = dist.new_group(tp_ranks(s, j))
            if (s, j) == (stage, cp_rank):
                pg = g
        for i in range(t if c > 1 else 0):
            g = dist.new_group(cp_ranks(s, i))
            if (s, i) == (stage, tp_rank):
                cp_pg = g
    group = DistGroup(t, tp_rank, pg, tp_ranks(stage, cp_rank))
    cp_group = None if c == 1 else DistGroup(
        c, cp_rank, cp_pg, cp_ranks(stage, tp_rank), log=group.log)
    return RankPlace(group, stage, rank + plane if stage < p - 1 else None,
                     rank - plane if stage > 0 else None, t, p, device, c,
                     cp_group)


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
