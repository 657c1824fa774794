"""Continuous-batching scheduler over a DecodeBackend (paper §V-C, serving).

Counterpart of ``repro.runtime.scheduler``: a fixed pool of KV-cache
slots, admission of queued requests into free slots between decode rounds
(one batch-1 prefill each), decode rounds over microbatch groups of slots
at per-sequence positions, and EOS/length eviction.  Each iteration
begins a round for every group with an active slot and none in flight
and pumps the backend's instruction queue (``runtime.schedule``) until a
round completes: on the fused backends one group spans every slot, one
round per iteration; on ``PPBackend`` at ``inflight`` = d up to d rounds
sit at different stages at once.  The queue is drained (``Sync``) before
any prefill writes caches or pages.  ``chunk_size`` (paged backends)
prefills one chunk of one request per iteration instead of whole
prompts.  Admission is conservative: a paged request's worst-case pages
are committed up front, so a decode step never runs out of pages.  On a
context-parallel backend (c > 1) a prompt pads to a multiple of c, which
admission counts, and chunked prefill is refused: the two are alternative
long-prompt strategies.

Per-step communication is recorded as ``StepRecord``s with the collective
counts ``commodel.comm_ops_for`` predicts; the paper's claim that these
counts do not depend on the batch is asserted at construction.  A c > 1
backend's whole prefills are recorded too (phase "prefill", the ring rows
of ``backend.prefill_comm_ops``); the JAX package records none.

Not ported yet: optimistic admission with preemption, deadlines,
cancellation and fault injection (ROADMAP item A8), and the disaggregated
prefill/decode scheduler (A9).
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.runtime.backends import DecodeBackend
from repro_torch.runtime.request import Request, RequestMetrics
from repro_torch.runtime.schedule import RoundResult, make_queue


# ---------------------------------------------------------------------------
# clocks (injectable so tests run on virtual time)
# ---------------------------------------------------------------------------


class WallClock:
    """Real time, relative to construction; ``wait_until`` sleeps."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def wait_until(self, t: float) -> None:
        delta = t - self.now()
        if delta > 0:
            time.sleep(delta)


class VirtualClock:
    """Deterministic clock for tests: time only moves via ``wait_until`` /
    ``advance`` — decode steps take zero virtual time."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def wait_until(self, t: float) -> None:
        self.t = max(self.t, t)

    def advance(self, dt: float) -> None:
        self.t += dt


# ---------------------------------------------------------------------------
# per-step traffic records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepRecord:
    """Communication of one scheduler iteration: one decode round over the
    slot batch, one prefill chunk (chunked-prefill mode), or one CP
    prefill pass (c > 1)."""

    step: int
    n_active: int
    collective_counts: Dict[str, int]     # predicted, per decode round/pass
    predicted_wire_bytes: float
    measured_transfers: Dict[str, int]    # PP boundary hops (0 here)
    phase: str = "decode"                 # "decode" | "prefill"
    rid: Optional[int] = None             # request, for prefill
    wall_s: float = 0.0                   # host wall time of the round/pass
    stage_busy: Optional[List[int]] = None
    stage_idle: Optional[List[int]] = None


def _count(ops) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for o in ops:
        counts[o.collective] = counts.get(o.collective, 0) + o.count
    return counts


def step_collective_counts(backend: DecodeBackend,
                           batch: int = 1) -> Dict[str, int]:
    """Collective call counts of ONE decode step, summed by collective."""
    return _count(backend.decode_comm_ops(batch=batch))


def assert_counts_batch_invariant(backend: DecodeBackend) -> None:
    """The paper's batch-invariance property: a decode step issues the same
    number of collectives at any batch size, and only wire bytes scale
    (linearly).  The fixed-capacity decode step depends on it."""
    base = backend.decode_comm_ops(batch=1)
    for batch in (2, backend.num_slots):
        if batch < 2:
            continue
        scaled = backend.decode_comm_ops(batch=batch)
        if step_collective_counts(backend, 1) != \
                step_collective_counts(backend, batch):
            raise AssertionError(
                f"per-step collective counts vary with batch={batch}: "
                f"{step_collective_counts(backend, 1)} vs "
                f"{step_collective_counts(backend, batch)}")
        for o1, ob in zip(base, scaled):
            if not np.isclose(ob.wire_bytes, batch * o1.wire_bytes):
                raise AssertionError(
                    f"wire bytes not linear in batch for {o1.collective}: "
                    f"{ob.wire_bytes} != {batch} * {o1.wire_bytes}")


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServingReport:
    metrics: List[RequestMetrics]
    steps: List[StepRecord]
    wall_time: float

    @property
    def total_tokens(self) -> int:
        return sum(m.num_generated for m in self.metrics)

    @property
    def throughput(self) -> float:
        return self.total_tokens / self.wall_time if self.wall_time else 0.0

    def tokens_by_rid(self) -> Dict[int, List[int]]:
        return {m.rid: list(m.tokens) for m in self.metrics}

    def occupancy(self) -> dict:
        """Decode-schedule occupancy from the decode records' per-stage busy
        and idle tick deltas: schedule ticks, per-stage busy fractions,
        decode tokens per tick (the schedule clock, not wall time)."""
        recs = [r for r in self.steps
                if r.phase == "decode" and r.stage_busy is not None]
        if not recs:
            return {"ticks": 0, "decode_tokens": 0, "tokens_per_tick": 0.0,
                    "stage_busy_fraction": [], "busy_fraction_mean": 0.0}
        n = len(recs[0].stage_busy)
        busy = [sum(r.stage_busy[s] for r in recs) for s in range(n)]
        idle = [sum(r.stage_idle[s] for r in recs) for s in range(n)]
        ticks = busy[0] + idle[0]   # every stage is busy or idle each tick
        frac = [b / max(b + i, 1) for b, i in zip(busy, idle)]
        dec_tokens = sum(r.n_active for r in recs)
        return {"ticks": ticks,
                "decode_tokens": dec_tokens,
                "tokens_per_tick": dec_tokens / ticks if ticks else 0.0,
                "stage_busy_fraction": frac,
                "busy_fraction_mean": float(np.mean(frac))}

    def summary(self) -> dict:
        def _pct(vals, q):
            return float(np.percentile(vals, q)) if vals else 0.0

        ttfts = [m.ttft for m in self.metrics if m.num_generated > 0]
        tpots = [m.tpot for m in self.metrics if m.num_generated > 1]
        e2es = [m.e2e for m in self.metrics]
        return {
            "requests": len(self.metrics),
            "total_tokens": self.total_tokens,
            "wall_time_s": self.wall_time,
            "throughput_tok_s": self.throughput,
            "ttft_mean_s": float(np.mean(ttfts)) if ttfts else 0.0,
            "ttft_p95_s": _pct(ttfts, 95),
            "tpot_mean_s": float(np.mean(tpots)) if tpots else 0.0,
            "tpot_p95_s": _pct(tpots, 95),
            "e2e_mean_s": float(np.mean(e2es)) if e2es else 0.0,
            "e2e_p95_s": _pct(e2es, 95),
        }


@dataclasses.dataclass
class _Active:
    req: Request
    metrics: RequestMetrics


@dataclasses.dataclass
class _Prefilling:
    """A request whose prompt is mid-way through chunked prefill."""

    req: Request
    metrics: RequestMetrics
    done: int = 0                 # prompt positions already prefilled


class Scheduler:
    """Continuous batching over ``backend.num_slots`` KV-cache slots.

    One ``step()`` = admit every arrived request a free slot (and, paged,
    the pool) can take, advance one prefill chunk when chunking, then ONE
    decode step over the slot batch, then evict finished sequences.
    Iterations with no decoding slot skip the decode step.
    """

    def __init__(self, backend: DecodeBackend, clock=None,
                 chunk_size: int = None, admission: str = "conservative",
                 faults=None):
        if admission == "optimistic":
            raise NotImplementedError(
                "optimistic admission with preemption-by-recompute is "
                "ROADMAP item A8")
        if admission != "conservative":
            raise ValueError(f"admission must be 'conservative', got "
                             f"{admission!r}")
        if faults is not None:
            raise NotImplementedError("fault injection is ROADMAP item A8")
        self.backend = backend
        self.clock = clock if clock is not None else WallClock()
        self.num_slots = backend.num_slots
        self.queue: List[Request] = []     # sorted by arrival, FIFO in ties
        self.free: List[int] = list(range(self.num_slots))
        self.active: Dict[int, _Active] = {}
        self.prefilling: Dict[int, _Prefilling] = {}   # slot -> state (FIFO)
        self.chunk_size = chunk_size
        self.paged = getattr(backend, "paged", False)
        if chunk_size is not None:
            if chunk_size < 1:
                raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
            if not self.paged:
                raise ValueError(
                    "chunked prefill writes straight into KV pages; "
                    "construct the backend with paged=True")
            if getattr(backend, "c", 1) > 1:
                raise ValueError(
                    "chunked prefill and context parallelism are "
                    "alternative long-prompt strategies; a c > 1 backend "
                    "prefills whole")
            # per-chunk counts do not depend on the chunk's length
            self._chunk_counts = _count(backend.chunk_comm_ops(chunk_size))
        self.tokens = np.zeros(self.num_slots, np.int32)
        self.pos = np.zeros(self.num_slots, np.int64)
        self.finished: List[RequestMetrics] = []
        self.step_log: List[StepRecord] = []
        self._step_i = 0
        self._rids: set = set()
        self._total_tokens = 0
        self._last_sig = None
        self._idle_iters = 0
        assert_counts_batch_invariant(backend)
        self._step_counts = step_collective_counts(backend, 1)
        self._queue = make_queue(backend)
        self._group_size = self._queue.group_size
        self._step_bytes = sum(
            o.wire_bytes
            for o in backend.decode_comm_ops(batch=self._group_size))

    # ------------------------------------------------------------- intake
    def submit(self, requests) -> None:
        reqs = [requests] if isinstance(requests, Request) else list(requests)
        seen: set = set()
        for r in reqs:
            if r.rid in self._rids or r.rid in seen:
                raise ValueError(
                    f"duplicate rid {r.rid}: already submitted this run")
            seen.add(r.rid)
            if r.deadline is not None or r.ttft_deadline is not None:
                raise NotImplementedError(
                    "request deadlines are ROADMAP item A8")
            # the last generated token is never fed back, so the highest
            # cache position written is prompt_len + max_new_tokens - 2;
            # a CP prompt pads to a multiple of c
            c = getattr(self.backend, "c", 1)
            need = max(r.prompt_len + r.max_new_tokens - 1,
                       -(-r.prompt_len // c) * c)
            w = self.backend.cfg.sliding_window
            if need > self.backend.max_len and not w:
                raise ValueError(
                    f"request {r.rid} needs {need} cache positions "
                    f"> max_len {self.backend.max_len}")
            if self.paged:
                # a request the EMPTY pool could not hold would never pass
                # the admission gate — reject it now instead of stalling
                need_pages = -(-need // self.backend.page_size)
                usable = self.backend.pool.num_pages - 1    # minus scratch
                if need_pages > usable:
                    raise ValueError(
                        f"request {r.rid} needs {need_pages} pages "
                        f"> pool capacity {usable}")
        for r in reqs:
            self._rids.add(r.rid)
            bisect.insort(self.queue, r, key=lambda x: x.arrival)

    # ------------------------------------------------------------- admission
    def _finish(self, slot: int, reason: str, now: float) -> None:
        st = self.active.pop(slot)
        st.metrics.finished = now
        st.metrics.finish_reason = reason
        self.finished.append(st.metrics)
        self.backend.free_slots([slot])
        self.free.append(slot)
        self.tokens[slot] = 0
        self.pos[slot] = 0

    @staticmethod
    def _stop_reason(req: Request, metrics: RequestMetrics) -> Optional[str]:
        """Model EOS, emulated EOS (``eos_pos``), or exhausted budget."""
        if req.eos_id is not None and metrics.tokens[-1] == req.eos_id:
            return "eos"
        if req.eos_pos is not None and \
                metrics.num_generated >= req.eos_pos:
            return "eos"
        if metrics.num_generated >= req.max_new_tokens:
            return "length"
        return None

    def _start_decoding(self, slot: int, req: Request, m: RequestMetrics,
                        tok: int) -> None:
        """The prompt is prefilled: stamp TTFT, record the first token and
        join the decoding set (or finish at once)."""
        now = self.clock.now()
        m.first_token = now
        m.tokens.append(tok)
        self._total_tokens += 1
        self.active[slot] = _Active(req, m)
        self.tokens[slot] = tok
        self.pos[slot] = req.prompt_len
        reason = self._stop_reason(req, m)
        if reason:
            self._finish(slot, reason, now)

    def _admit_ready(self) -> None:
        while self.free and self.queue and \
                self.queue[0].arrival <= self.clock.now():
            req = self.queue[0]
            if self.paged and not self.backend.can_admit(
                    req.prompt_len, req.max_new_tokens):
                # a free slot but not enough pages: stays queued (head of
                # line, so admission order stays arrival order)
                break
            # Sync: no round may still read what the prefill writes
            self._drain_queue()
            self.queue.pop(0)
            slot = self.free.pop(0)
            m = RequestMetrics(rid=req.rid, prompt_len=req.prompt_len,
                               arrival=req.arrival, admitted=self.clock.now())
            cp = getattr(self.backend, "c", 1) > 1
            if cp:
                # the rounds before it were charged their own hops
                self.backend.drain_transfers()
            t0 = time.perf_counter()
            if self.paged:
                self.backend.begin_prefill(slot, req.prompt_len,
                                           req.max_new_tokens)
                if self.chunk_size is not None:
                    self.prefilling[slot] = _Prefilling(req, m)
                    continue
                tok = int(self.backend.prefill_whole(slot, req.prompt))
                self.backend.finish_prefill(slot)
            else:
                tok = int(self.backend.prefill_into_slots([req.prompt],
                                                          [slot])[0])
            if cp:
                self._log_cp_prefill(req, time.perf_counter() - t0)
            self._queue.note_prefill(slot)
            self._start_decoding(slot, req, m, tok)

    def _log_cp_prefill(self, req: Request, wall: float) -> None:
        """Record one whole CP prefill pass with its predicted collectives
        (the ring rows) and the boundary hops it made."""
        ops = self.backend.prefill_comm_ops(req.prompt_len)
        self.step_log.append(StepRecord(
            step=self._step_i, n_active=len(self.active),
            collective_counts=_count(ops),
            predicted_wire_bytes=sum(o.wire_bytes for o in ops),
            measured_transfers=self.backend.drain_transfers(),
            phase="prefill", rid=req.rid, wall_s=wall))
        self._step_i += 1

    def _advance_prefill(self) -> None:
        """Run ONE prefill chunk of the oldest mid-prefill request; after
        the final chunk the request joins the decoding set."""
        self._drain_queue()      # Sync: a chunk writes the slot's pages
        slot = next(iter(self.prefilling))
        st = self.prefilling[slot]
        start = st.done
        end = min(start + self.chunk_size, st.req.prompt_len)
        t0 = time.perf_counter()
        tok = self.backend.prefill_chunk(slot, st.req.prompt[start:end],
                                         start)
        wall = time.perf_counter() - t0
        st.done = end
        self._queue.note_prefill(slot)
        self.step_log.append(StepRecord(
            step=self._step_i, n_active=len(self.active),
            collective_counts=dict(self._chunk_counts),
            predicted_wire_bytes=sum(
                o.wire_bytes
                for o in self.backend.chunk_comm_ops(end - start)),
            measured_transfers=self.backend.drain_transfers(),
            phase="prefill", rid=st.req.rid, wall_s=wall))
        self._step_i += 1
        if end < st.req.prompt_len:
            return
        del self.prefilling[slot]
        self.backend.finish_prefill(slot)
        self._start_decoding(slot, st.req, st.metrics, int(tok))

    # ------------------------------------------------------------- stepping
    def _refill_rounds(self) -> None:
        """Begin one decode round for every microbatch group with an active
        slot and no round in flight (on the fused backends the one group
        spans every slot)."""
        G = self._group_size
        pending = self._queue.pending_groups()
        for g in range(self.num_slots // G):
            if g in pending:
                continue
            lo = g * G
            if any(s in self.active for s in range(lo, lo + G)):
                self._queue.begin_round(g, self.tokens, self.pos)

    def _drain_queue(self) -> None:
        """Complete every in-flight round (the ``Sync`` instruction) before
        a prefill writes caches or pages a round may still read; the
        rounds' hops were charged to them, so the transfer cursor moves on
        past them."""
        drained = bool(self._queue.in_flight)
        for res in self._queue.sync():
            self._complete_round(res)
        if drained:
            self.backend.drain_transfers()

    def _complete_round(self, res: RoundResult) -> None:
        """Record one decode round and append its tokens to the slots that
        are still active (``n_active``: the rows the round appends to)."""
        now = self.clock.now()
        appended = sum(1 for slot in res.slots if slot in self.active)
        self.step_log.append(StepRecord(
            step=self._step_i, n_active=appended,
            collective_counts=dict(self._step_counts),
            predicted_wire_bytes=self._step_bytes,
            measured_transfers=dict(res.transfers),
            wall_s=res.wall_s,
            stage_busy=list(res.stage_busy),
            stage_idle=list(res.stage_idle)))
        self._step_i += 1
        base = res.slots[0]
        for slot in res.slots:
            st = self.active.get(slot)
            if st is None:
                continue
            tok = int(res.tokens[slot - base])
            st.metrics.tokens.append(tok)
            self._total_tokens += 1
            self.tokens[slot] = tok
            self.pos[slot] += 1
            reason = self._stop_reason(st.req, st.metrics)
            if reason:
                self._finish(slot, reason, now)

    def step(self) -> bool:
        """One scheduler iteration; returns False when fully drained."""
        if not self.queue and not self.active and not self.prefilling \
                and not self._queue.in_flight:
            return False
        self._admit_ready()
        self.backend.drain_transfers()      # prefill hops: not decode traffic
        if self.prefilling:
            self._advance_prefill()
        if not self.active and not self._queue.in_flight:
            # nothing decodes: skip the step; move the clock to the next
            # arrival only when no prefill is in flight either
            if not self.prefilling and self.queue:
                self.clock.wait_until(self.queue[0].arrival)
            return self._next(True)
        self._refill_rounds()
        for res in self._queue.pump():
            self._complete_round(res)
        return self._next(bool(self.queue or self.active or self.prefilling
                               or self._queue.in_flight))

    def _next(self, more: bool) -> bool:
        """Stall guard: a live scheduler changes something every iteration;
        a signature frozen for 10000 iterations is a logic error."""
        if not more:
            return False
        sig = (len(self.queue), len(self.active), len(self.prefilling),
               len(self.finished), self._total_tokens, self._step_i,
               self.clock.now())
        if sig == self._last_sig:
            self._idle_iters += 1
            if self._idle_iters > 10_000:
                raise RuntimeError(
                    "scheduler stalled: no progress in 10000 iterations "
                    f"(queue={len(self.queue)} active={len(self.active)} "
                    f"prefilling={len(self.prefilling)})")
        else:
            self._idle_iters = 0
            self._last_sig = sig
        return True

    def run(self, requests=None) -> ServingReport:
        """Drive until every submitted request has finished."""
        t0 = self.clock.now()
        if requests is not None:
            self.submit(requests)
        while self.step():
            pass
        report = ServingReport(
            metrics=sorted(self.finished, key=lambda m: m.rid),
            steps=self.step_log, wall_time=self.clock.now() - t0)
        self.finished, self.step_log = [], []
        self._step_i = 0
        self._rids = set()
        self._last_sig, self._idle_iters = None, 0
        return report


class DisaggScheduler:
    """Disaggregated prefill/decode pools: ROADMAP item A9."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "disaggregated prefill/decode serving is ROADMAP item A9")
