"""Instruction queues the scheduler drains and refills.

Counterpart of ``repro.runtime.schedule``.  Every backend hands the
scheduler an instruction queue (``make_queue``):

- ``DynamicPPQueue`` (``PPBackend``) keeps up to ``backend.inflight``
  microbatch groups in flight.  A group's decode round is a chain
  ``StageForward(0) -> BoundarySend/Recv(0 -> 1) -> ... ->
  StageForward(p-1) -> SampleToken``; each tick issues at most one
  ``StageForward`` per stage, the deepest stage first and, within a stage,
  the oldest round.  Its ticks, per-stage busy and idle counts and
  instruction log are what ``commodel.pp_schedule_stats`` predicts in
  closed form.
- ``FusedQueue`` (``ModelBackend``, ``TPBackend`` and any backend without
  ``make_queue``) wraps the fused ``decode_step`` as a one-instruction
  queue.

A round's only ready instruction is the head of its chain; rounds of
distinct groups touch distinct caches (or disjoint block-table rows of the
paged pools), and at most one round waits at any stage boundary, so the
boundary's receive buffers are never overwritten before they are read.

The module duck-types against the backend's ``start_round`` /
``run_stage`` / ``send_boundary`` / ``decode_step`` surface and never
imports ``runtime.backends`` (which imports it).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Set

import numpy as np


# ---------------------------------------------------------------------------
# instruction set: the executed program is logged, one record per issue
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageForward:
    """Run stage ``stage`` for microbatch group ``mb``."""
    mb: int
    stage: int


@dataclasses.dataclass(frozen=True)
class BoundarySend:
    """Ship the boundary pair off stage ``stage`` for group ``mb``."""
    mb: int
    stage: int


@dataclasses.dataclass(frozen=True)
class BoundaryRecv:
    """Land the boundary pair on stage ``stage`` for group ``mb``."""
    mb: int
    stage: int


@dataclasses.dataclass(frozen=True)
class PrefillChunk:
    """A prefill (or prefill chunk) advanced for slot ``mb``; prefill runs
    on the backend's fused path."""
    mb: int


@dataclasses.dataclass(frozen=True)
class SampleToken:
    """Greedy-sample the last stage's logits for group ``mb``."""
    mb: int


@dataclasses.dataclass(frozen=True)
class Sync:
    """Barrier: every in-flight round was drained before a cache or page
    write (admission prefill, chunk) could alias it."""


@dataclasses.dataclass
class RoundResult:
    """One completed decode round: ``tokens[i]`` belongs to ``slots[i]``.
    ``ticks``/``stage_busy``/``stage_idle`` are deltas of the queue's
    schedule clock since the previous completion; ``transfers`` counts the
    round's own boundary hops."""
    mb: int
    slots: List[int]
    tokens: np.ndarray
    transfers: Dict[str, int]
    wall_s: float
    ticks: int
    stage_busy: List[int]
    stage_idle: List[int]


@dataclasses.dataclass
class _Round:
    """An in-flight decode round; ``x`` is the head's input (token ids at
    stage 0, the received boundary pair after)."""
    mb: int
    seq: int
    slots: List[int]
    x: object
    pos: object
    bt: object
    stage: int = 0
    tr_count: int = 0
    tr_bytes: int = 0


# ---------------------------------------------------------------------------
# dynamic PP queue
# ---------------------------------------------------------------------------


class DynamicPPQueue:
    """Priority-driven dynamic schedule over a ``PPBackend``'s stages.

    One tick is one sweep over the stages, deepest first: each stage runs
    the oldest round whose head targets it (or idles).  The tick's tail
    moves every produced boundary to its next stage (the transfers are
    charged to the round) and samples the rounds that cleared the last
    stage.  Deepest-first makes the schedule drain-first, so with depth
    >= p every stage is busy every tick once the pipeline fills."""

    def __init__(self, backend):
        self.backend = backend
        self.p = int(backend.p)
        self.depth = int(backend.inflight)
        self.group_size = int(backend.group_size)
        self._rounds: List[_Round] = []
        self._seq = 0
        self.ticks = 0
        self.busy = [0] * self.p
        self.idle = [0] * self.p
        self.log: List[object] = []
        self._mark = (0, [0] * self.p, [0] * self.p)

    @property
    def in_flight(self) -> int:
        return len(self._rounds)

    def busy_groups(self) -> Set[int]:
        """Groups with issued work in flight: their caches and pages must
        not be freed or reused."""
        return {r.mb for r in self._rounds}

    def pending_groups(self) -> Set[int]:
        """Groups that must not get another ``begin_round``."""
        return {r.mb for r in self._rounds}

    def begin_round(self, g: int, tokens: np.ndarray, pos: np.ndarray):
        """Start one decode round of group ``g`` from the scheduler's
        per-slot tokens and positions; the backend extends the group's
        pages here, before any instruction issues."""
        if any(r.mb == g for r in self._rounds):
            raise RuntimeError(f"group {g} already has a round in flight")
        x, pos_g, bt = self.backend.start_round(g, tokens, pos)
        self._seq += 1
        lo = g * self.group_size
        self._rounds.append(_Round(
            mb=g, seq=self._seq, slots=list(range(lo, lo + self.group_size)),
            x=x, pos=pos_g, bt=bt))

    def pump(self) -> List[RoundResult]:
        """Tick until at least one round completes; return the completed
        rounds (none only when nothing is in flight)."""
        if not self._rounds:
            return []
        t0 = time.perf_counter()
        done: List[RoundResult] = []
        while not done:
            done = self._tick()
        wall = (time.perf_counter() - t0) / len(done)
        for res in done:
            res.wall_s = wall
        return done

    def sync(self) -> List[RoundResult]:
        """Drain every in-flight round (the ``Sync`` instruction)."""
        out: List[RoundResult] = []
        drained = bool(self._rounds)
        while self._rounds:
            out.extend(self.pump())
        if drained:
            self.log.append(Sync())
        return out

    def abort_all(self) -> None:
        """Drop every in-flight round without completing it."""
        self._rounds.clear()

    def note_prefill(self, slot: int) -> None:
        self.log.append(PrefillChunk(mb=slot))

    def _tick(self) -> List[RoundResult]:
        self.ticks += 1
        ran = []
        for s in range(self.p - 1, -1, -1):
            cand = None
            for r in self._rounds:
                if r.stage == s and (cand is None or r.seq < cand.seq):
                    cand = r
            if cand is None:
                self.idle[s] += 1
                continue
            out = self.backend.run_stage(cand.mb, s, cand.x, cand.pos,
                                         cand.bt)
            self.busy[s] += 1
            self.log.append(StageForward(mb=cand.mb, stage=s))
            ran.append((cand, out))
        transfers = self.backend.engine.transfers
        finished = []
        for r, out in ran:
            if r.stage < self.p - 1:
                n0 = len(transfers)
                r.x = self.backend.send_boundary(out, r.stage)
                for rec in transfers[n0:]:
                    r.tr_count += rec.count
                    r.tr_bytes += rec.bytes
                self.log.append(BoundarySend(mb=r.mb, stage=r.stage))
                self.log.append(BoundaryRecv(mb=r.mb, stage=r.stage + 1))
                r.stage += 1
            else:
                finished.append((r, out))
        results = []
        for r, logits in finished:
            self._rounds.remove(r)
            toks = self.backend._first_token(logits)
            self.log.append(SampleToken(mb=r.mb))
            results.append(self._result(r, toks))
        return results

    def _result(self, r: _Round, toks: np.ndarray) -> RoundResult:
        d_ticks = self.ticks - self._mark[0]
        d_busy = [b - m for b, m in zip(self.busy, self._mark[1])]
        d_idle = [i - m for i, m in zip(self.idle, self._mark[2])]
        self._mark = (self.ticks, list(self.busy), list(self.idle))
        return RoundResult(
            mb=r.mb, slots=r.slots, tokens=np.asarray(toks, np.int32),
            transfers={"count": r.tr_count, "bytes": r.tr_bytes},
            wall_s=0.0, ticks=d_ticks, stage_busy=d_busy, stage_idle=d_idle)


# ---------------------------------------------------------------------------
# degenerate fused queue
# ---------------------------------------------------------------------------


class FusedQueue:
    """The fused ``decode_step`` as a one-instruction queue (group 0 spans
    every slot); nothing is issued before ``pump``."""

    def __init__(self, backend):
        self.backend = backend
        self.p = 1
        self.depth = 1
        self.group_size = int(backend.num_slots)
        self._round = None
        self.ticks = 0
        self.busy = [0]
        self.idle = [0]
        self.log: List[object] = []

    @property
    def in_flight(self) -> int:
        return 0 if self._round is None else 1

    def busy_groups(self) -> Set[int]:
        # a pending round has issued nothing, so it pins no pages
        return set()

    def pending_groups(self) -> Set[int]:
        return set() if self._round is None else {0}

    def begin_round(self, g: int, tokens: np.ndarray, pos: np.ndarray):
        if self._round is not None:
            raise RuntimeError("fused queue already has a round pending")
        self._round = (g, tokens, pos)

    def pump(self) -> List[RoundResult]:
        if self._round is None:
            return []
        g, tokens, pos = self._round
        t0 = time.perf_counter()
        nxt = self.backend.decode_step(tokens, pos)
        wall = time.perf_counter() - t0
        self._round = None
        self.ticks += 1
        self.busy[0] += 1
        self.log.append(StageForward(mb=g, stage=0))
        self.log.append(SampleToken(mb=g))
        tr = self.backend.drain_transfers()
        return [RoundResult(
            mb=g, slots=list(range(self.group_size)),
            tokens=np.asarray(nxt, np.int32), transfers=dict(tr),
            wall_s=wall, ticks=1, stage_busy=[1], stage_idle=[0])]

    def sync(self) -> List[RoundResult]:
        """Complete the pending round, if any, before a cache/page write."""
        out: List[RoundResult] = []
        if self._round is not None:
            out = self.pump()
            self.log.append(Sync())
        return out

    def abort_all(self) -> None:
        self._round = None

    def note_prefill(self, slot: int) -> None:
        self.log.append(PrefillChunk(mb=slot))


def make_queue(backend):
    """The instruction queue of ``backend``, resolved through its class (a
    proxy that delegates attributes keeps the queue bound to the proxy); a
    class without ``make_queue`` gets the fused queue."""
    mk = getattr(type(backend), "make_queue", None)
    if mk is None:
        return FusedQueue(backend)
    return mk(backend)
