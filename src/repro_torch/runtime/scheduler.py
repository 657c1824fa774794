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
prompts.  On a context-parallel backend (c > 1) a prompt pads to a
multiple of c, which admission counts, and chunked prefill is refused:
the two are alternative long-prompt strategies.

Failure semantics:

  * **Admission.**  ``admission="conservative"`` (default) commits every
    paged request's worst-case decode budget up front, so a decode step
    never runs out of pages; ``"optimistic"`` admits on the pages the
    prompt claims now and recovers from pool exhaustion by preemption.
  * **Preemption by recompute.**  When a decode round's page claim raises
    ``MemoryError``, the youngest active request (of a group with no
    round in flight) gives up its slot and pages and is requeued with its
    generated tokens.  Re-admission prefills prompt + generated prefix in
    one pass (or in chunks); greedy decode is deterministic, so the
    pass's final-position token must equal the last token generated
    before preemption (a ``RuntimeError`` otherwise).  Each recompute is
    logged as a phase "recompute" ``StepRecord`` with the predicted
    prefill collectives of the prefix
    (``commodel.preemption_recompute_ops``) and the measured PP hops.
  * **Deadlines and cancellation.**  ``Request.deadline`` /
    ``ttft_deadline`` shed requests that can no longer meet them
    (``finish_reason="deadline"``); ``cancel(rid)`` sheds on demand
    ("cancelled") wherever the request is.
  * **Faults.**  With a ``runtime.faults.FaultInjector`` attached, faults
    drawn at the decode / prefill / pool / pp_transfer sites are
    absorbed: transient ones retry with exponential backoff on the
    scheduler's clock, permanent ones finish the affected requests with
    "error", an injected pool exhaustion takes the preemption path, and a
    transfer delay moves the clock.

Prefix caching: on a backend with a ``PrefixIndex`` admission looks every
prompt, and every recompute prefix, up in the index, adopts the hit's
pages and prefills only the suffix (``StepRecord.cached_prefix_len``);
a finished prompt's full blocks are indexed.

``DisaggScheduler`` runs two backends that share one ``KVPool`` as a
prefill pool and a decode pool: long prompts prefill on the first, their
full blocks ship page by page to the second (``export_page`` /
``import_page``, phase "handoff" records whose measured bytes must equal
``commodel.kv_handoff_ops``), and the decode pool admits them through its
prefix index.

On real ranks (a backend with a ``place``) every process runs its own
scheduler over the same trace; they stay in step because every one of
their decisions reads rank 0's clock (``SharedClock``) and the same
greedy tokens, so they admit the same requests and issue the same
collectives in the same order.

Per-step communication is recorded as ``StepRecord``s with the collective
counts ``commodel.comm_ops_for`` predicts; the paper's claim that these
counts do not depend on the batch is asserted at construction.  A c > 1
backend's whole prefills are recorded too (phase "prefill", the ring rows
of ``backend.prefill_comm_ops``); the JAX package records none.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.commodel import kv_handoff_ops, kv_handoff_pages
from repro_torch.models.layers import torch_dtype
from repro_torch.runtime.backends import DecodeBackend
from repro_torch.runtime.faults import PermanentFault, TransientFault
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


class SharedClock:
    """Rank 0's clock on every rank of a ``torch.distributed`` world: each
    ``now()`` broadcasts rank 0's reading of ``base`` (one f64, on
    ``device``), so processes whose own clocks differ admit and shed
    alike, as vLLM's rank-0 worker decides for the others.  Only rank 0
    waits in ``wait_until``: the others return at once and block in the
    next ``now()`` (or collective) until rank 0 reaches it, so a rank
    whose own clock reads behind rank 0's never holds the world past
    rank 0's deadline."""

    def __init__(self, base, device):
        self.base = base
        self.device = torch.device(device)

    def now(self) -> float:
        t = torch.tensor([self.base.now()], dtype=torch.float64,
                         device=self.device)
        dist.broadcast(t, src=0)
        return float(t.item())

    def wait_until(self, t: float) -> None:
        if dist.get_rank() == 0:
            self.base.wait_until(t)


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
    slot batch, one prefill chunk (chunked-prefill mode), one CP prefill
    pass (c > 1), one preemption's recompute pass or chunk, or one
    disaggregated KV handoff."""

    step: int
    n_active: int
    collective_counts: Dict[str, int]     # predicted, per decode round/pass
    predicted_wire_bytes: float
    measured_transfers: Dict[str, int]    # PP boundary hops / handoff bytes
    phase: str = "decode"   # "decode" | "prefill" | "recompute" | "handoff"
    rid: Optional[int] = None             # request, for non-decode phases
    prefix_len: Optional[int] = None      # recomputed positions (recompute)
    cached_prefix_len: Optional[int] = None   # prefix-cache hit: positions
    #                                           adopted instead of computed
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


_NORMAL_FINISH = ("length", "eos")


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

    @property
    def preemptions(self) -> int:
        return sum(m.preemptions for m in self.metrics)

    @property
    def retries(self) -> int:
        return sum(m.retries for m in self.metrics)

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

        # a shed request may have no first token: keep its zero stamp out
        # of the TTFT statistics
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
            "preemptions": self.preemptions,
            "retries": self.retries,
            "shed": len([m for m in self.metrics
                         if m.finish_reason not in _NORMAL_FINISH]),
        }


@dataclasses.dataclass
class _Active:
    req: Request
    metrics: RequestMetrics
    seq: int = 0                  # admission sequence (preemption order)


@dataclasses.dataclass
class _Prefilling:
    """A request whose prompt (or recompute prefix) is mid-way through
    chunked prefill."""

    req: Request
    metrics: RequestMetrics
    prefix: np.ndarray            # the prompt, or prompt + generated prefix
    done: int = 0                 # prefix positions already prefilled
    resume: Optional[List[int]] = None   # generated tokens (recompute only)
    cached: int = 0               # prefix-cache hit: positions adopted at
    #                               admission, chunking starts there


class Scheduler:
    """Continuous batching over ``backend.num_slots`` KV-cache slots.

    One ``step()`` = shed expired requests, admit every arrived request a
    free slot (and, paged, the pool) can take, advance one prefill chunk
    when chunking, then ONE decode round per idle microbatch group behind
    the recovery ladder (preempt on pool exhaustion, retry transient
    faults, error-finish on permanent ones), then evict finished
    sequences.  Iterations with no decoding slot skip the decode step.
    ``admission``, ``faults``, ``retry_limit`` and ``retry_backoff`` are
    the failure-semantics knobs of the module docstring.
    """

    def __init__(self, backend: DecodeBackend, clock=None,
                 chunk_size: int = None, admission: str = "conservative",
                 faults=None, retry_limit: int = 3,
                 retry_backoff: float = 0.05):
        self.backend = backend
        self.clock = clock if clock is not None else WallClock()
        place = getattr(backend, "place", None)
        if place is not None:
            self.clock = SharedClock(self.clock, place.device)
        self.num_slots = backend.num_slots
        self.queue: List[Request] = []     # sorted by arrival, FIFO in ties
        self.free: List[int] = list(range(self.num_slots))
        self.active: Dict[int, _Active] = {}
        self.prefilling: Dict[int, _Prefilling] = {}   # slot -> state (FIFO)
        self.chunk_size = chunk_size
        self.paged = getattr(backend, "paged", False)
        if admission not in ("conservative", "optimistic"):
            raise ValueError(
                f"admission must be 'conservative' or 'optimistic', "
                f"got {admission!r}")
        if admission == "optimistic" and not self.paged:
            raise ValueError(
                "optimistic admission relaxes the KV-page commitment; "
                "contiguous slot backends have nothing to overcommit — "
                "construct the backend with paged=True")
        self.admission = admission
        self.faults = faults
        if retry_limit < 0:
            raise ValueError(f"retry_limit must be >= 0, got {retry_limit}")
        self.retry_limit = int(retry_limit)
        self.retry_backoff = float(retry_backoff)
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
        self._preempted: Dict[int, RequestMetrics] = {}  # rid -> metrics
        self._adm_seq = 0
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
        c = getattr(self.backend, "c", 1)
        seen: set = set()
        for r in reqs:
            if r.rid in self._rids or r.rid in seen:
                raise ValueError(
                    f"duplicate rid {r.rid}: already submitted this run")
            seen.add(r.rid)
            # the last generated token is never fed back, so the highest
            # cache position written is prompt_len + max_new_tokens - 2;
            # a CP prompt pads to a multiple of c
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
            self._enqueue(r)

    def _enqueue(self, req: Request) -> None:
        """Sorted insert by arrival; ``insort`` is right-biased, so equal
        arrivals keep submission order and a preempted request requeues
        behind its same-arrival peers."""
        bisect.insort(self.queue, req, key=lambda r: r.arrival)

    # ------------------------------------------------------------- lifecycle
    def cancel(self, rid: int) -> bool:
        """Cancel a request wherever it is — queued, mid-prefill or
        decoding.  Its generated tokens are kept and it finishes with
        ``finish_reason="cancelled"``.  False when the rid is unknown or
        already finished."""
        now = self.clock.now()
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                self._shed_queued(req, "cancelled", now)
                return True
        for slot, st in list(self.prefilling.items()):
            if st.req.rid == rid:
                self._abort_prefill(slot, "cancelled", now)
                return True
        for slot, st in list(self.active.items()):
            if st.req.rid == rid:
                # complete the rounds in flight first: freeing pages a
                # round still writes would corrupt another group's round
                self._drain_queue()
                if slot in self.active and self.active[slot].req.rid == rid:
                    self._finish(slot, "cancelled", self.clock.now())
                return True         # the drain may have finished it anyway
        return False

    @staticmethod
    def _expired(req: Request, now: float, pre_first_token: bool) -> bool:
        if req.deadline is not None and now > req.arrival + req.deadline:
            return True
        return pre_first_token and req.ttft_deadline is not None \
            and now > req.arrival + req.ttft_deadline

    def _shed_queued(self, req: Request, reason: str, now: float) -> None:
        """Finish a request straight out of the queue (deadline, cancel);
        a preempted one keeps the tokens it generated before."""
        m = self._preempted.pop(req.rid, None)
        if m is None:
            m = RequestMetrics(rid=req.rid, prompt_len=req.prompt_len,
                               arrival=req.arrival)
        m.finished = now
        m.finish_reason = reason
        self.finished.append(m)

    def _abort_prefill(self, slot: int, reason: str, now: float) -> None:
        st = self.prefilling.pop(slot)
        self.backend.free_slots([slot])
        self.free.append(slot)
        st.metrics.finished = now
        st.metrics.finish_reason = reason
        self.finished.append(st.metrics)

    def _shed_expired(self, now: float) -> None:
        """Drop every queued or mid-prefill request that can no longer meet
        its deadline, head of line or not."""
        for req in [r for r in self.queue
                    if self._expired(r, now, r.rid not in self._preempted)]:
            self.queue.remove(req)
            self._shed_queued(req, "deadline", now)
        for slot, st in list(self.prefilling.items()):
            if self._expired(st.req, now, st.resume is None):
                self._abort_prefill(slot, "deadline", now)

    # ------------------------------------------------------------- faults
    def _apply_fault(self, site: str) -> None:
        if self.faults is None:
            return
        f = self.faults.draw(site)
        if f is None:
            return
        if f.kind == "delay":
            self.clock.wait_until(self.clock.now() + f.delay_s)
        elif f.kind == "oom":
            raise MemoryError(f"injected fault at {site}")
        elif f.kind == "transient":
            raise TransientFault(f"injected fault at {site}")
        else:
            raise PermanentFault(f"injected fault at {site}")

    def _backoff(self, attempt: int) -> None:
        """Exponential backoff before retry ``attempt`` (1-based), on the
        scheduler's clock so a virtual clock shows the waits."""
        self.clock.wait_until(self.clock.now()
                              + self.retry_backoff * 2.0 ** (attempt - 1))

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

    def _preempt_youngest(self) -> None:
        """Evict the most recently admitted active request: free its slot
        and pages and requeue it with its generated tokens (re-admission
        recomputes the prefix).  Victims come from groups with no round in
        flight — freeing pages a round still writes would let the next
        ``start_round`` hand them out mid-write; the group whose
        ``start_round`` raised is never busy, so a candidate exists."""
        busy = self._queue.busy_groups()
        cands = [s for s in self.active if s // self._group_size not in busy]
        slot = max(cands or self.active,
                   key=lambda s: self.active[s].seq)
        st = self.active.pop(slot)
        st.metrics.preemptions += 1
        self._preempted[st.req.rid] = st.metrics
        self.backend.free_slots([slot])
        self.free.append(slot)
        self.tokens[slot] = 0
        self.pos[slot] = 0
        self._enqueue(st.req)

    def _run_prefill(self, slot: int, prefix: np.ndarray,
                     metrics: RequestMetrics,
                     start: int = 0) -> Optional[int]:
        """One whole-prefix prefill pass with fault draws and bounded
        retries; returns the final position's greedy token, or None when
        the request errored out (the caller frees the slot).  ``start``
        skips a cache hit's adopted positions; a retry rewrites the same
        rows, so it is idempotent."""
        attempt = 0
        while True:
            try:
                self._apply_fault("prefill")
                if self.paged:
                    tok = int(self.backend.prefill_whole(slot, prefix,
                                                         start=start))
                    self.backend.finish_prefill(slot)
                else:
                    tok = int(self.backend.prefill_into_slots(
                        [prefix], [slot])[0])
                return tok
            except TransientFault:
                attempt += 1
                if attempt > self.retry_limit:
                    return None
                metrics.retries += 1
                self._backoff(attempt)
            except PermanentFault:
                return None

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
                        tok: int, now: float) -> None:
        """The prompt is prefilled: index its full blocks, stamp TTFT,
        record the first token and join the decoding set (or finish at
        once)."""
        if self.paged:
            self.backend.cache_prefix(slot, req.prompt)
        m.first_token = now
        m.tokens.append(tok)
        self._total_tokens += 1
        self.active[slot] = _Active(req, m, seq=self._adm_seq)
        self.tokens[slot] = tok
        self.pos[slot] = req.prompt_len
        reason = self._stop_reason(req, m)
        if reason:
            self._finish(slot, reason, now)

    def _admit_ready(self) -> None:
        optimistic = self.admission == "optimistic"
        cp = getattr(self.backend, "c", 1) > 1
        while self.free and self.queue and \
                self.queue[0].arrival <= self.clock.now():
            req = self.queue[0]
            state = self._preempted.get(req.rid)
            if state is None:
                prefix_len = req.prompt_len
                budget = req.max_new_tokens
            else:
                # recompute prefix: the prompt and every generated token but
                # the last (emitted, never fed back); the worst case is the
                # first admission's
                prefix_len = req.prompt_len + len(state.tokens) - 1
                budget = req.max_new_tokens - len(state.tokens) + 1
            if self.paged and not self.backend.can_admit(
                    prefix_len, budget, optimistic=optimistic):
                # a free slot but not enough pages: stays queued (head of
                # line, so admission order stays arrival order)
                break
            # Sync: no round may still read what the prefill writes
            self._drain_queue()
            self.queue.pop(0)
            slot = self.free.pop(0)
            self._adm_seq += 1
            if state is None:
                m = RequestMetrics(rid=req.rid, prompt_len=req.prompt_len,
                                   arrival=req.arrival,
                                   admitted=self.clock.now())
                prefix = req.prompt
                resume = None
            else:
                m = self._preempted.pop(req.rid)
                prefix = np.concatenate(
                    [req.prompt, np.asarray(m.tokens[:-1], np.int32)])
                resume = list(m.tokens)
            hit = 0
            if self.paged:
                # the lookup covers recompute prefixes too: they begin with
                # the prompt whose blocks were indexed at first admission.
                # Generated tokens are never indexed, so a hit never covers
                # the tail whose final token the identity check reads.
                if getattr(self.backend, "prefix_index", None) is not None:
                    hit = self.backend.begin_prefill_cached(slot, prefix,
                                                            budget)
                    if resume is None:
                        m.cached_prefix_len = hit
                else:
                    self.backend.begin_prefill(slot, len(prefix), budget)
                if self.chunk_size is not None:
                    self.prefilling[slot] = _Prefilling(
                        req, m, prefix=prefix, resume=resume, done=hit,
                        cached=hit)
                    continue
            if resume is not None or cp:
                # the pass's boundary hops get a record of their own
                self.backend.drain_transfers()
            t0 = time.perf_counter()
            tok = self._run_prefill(slot, prefix, m, start=hit)
            wall = time.perf_counter() - t0
            if tok is None:
                self.backend.free_slots([slot])
                self.free.append(slot)
                m.finished = self.clock.now()
                m.finish_reason = "error"
                self.finished.append(m)
                continue
            self._queue.note_prefill(slot)
            now = self.clock.now()
            if resume is not None:
                self._log_recompute(req.rid, len(prefix), cached=hit)
                self._resume_active(slot, req, m, resume, len(prefix), tok)
                continue
            if cp:
                self._log_cp_prefill(req, wall)
            self._start_decoding(slot, req, m, tok, now)

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

    def _log_recompute(self, rid: int, prefix_len: int,
                       cached: int = 0) -> None:
        """Record one recompute pass.  A warm recompute (a cache hit at
        re-admission) runs only ``prefix_len - cached`` positions, and the
        predicted bytes are those of that suffix; the counts do not depend
        on the length."""
        ops = self.backend.prefill_comm_ops(prefix_len - cached)
        self.step_log.append(StepRecord(
            step=self._step_i, n_active=len(self.active),
            collective_counts=_count(ops),
            predicted_wire_bytes=sum(o.wire_bytes for o in ops),
            measured_transfers=self.backend.drain_transfers(),
            phase="recompute", rid=rid, prefix_len=prefix_len,
            cached_prefix_len=cached or None))
        self._step_i += 1

    def _resume_active(self, slot: int, req: Request, m: RequestMetrics,
                       resume: List[int], prefix_len: int,
                       tok: int) -> None:
        """Rejoin the decoding set after a recompute pass, whose
        final-position greedy token must be the last token the request
        generated before preemption: anything else means the recomputed
        K/V diverged."""
        if tok != resume[-1]:
            raise RuntimeError(
                f"preemption token-identity violated for rid {req.rid}: "
                f"recompute of {prefix_len} positions produced token {tok}, "
                f"stream had {resume[-1]}")
        self.active[slot] = _Active(req, m, seq=self._adm_seq)
        self.tokens[slot] = resume[-1]
        self.pos[slot] = prefix_len
        # admitted / first_token keep their first stamps: the recompute
        # costs TPOT and E2E, not TTFT

    def _advance_prefill(self) -> None:
        """Run ONE prefill chunk of the oldest mid-prefill request; after
        the final chunk the request joins the decoding set (a recompute
        prefix rejoins it, its chunks logged as phase "recompute")."""
        self._drain_queue()      # Sync: a chunk writes the slot's pages
        slot = next(iter(self.prefilling))
        st = self.prefilling[slot]
        start = st.done
        end = min(start + self.chunk_size, len(st.prefix))
        attempt = 0
        while True:
            try:
                self._apply_fault("prefill")
                t0 = time.perf_counter()
                tok = self.backend.prefill_chunk(
                    slot, st.prefix[start:end], start)
                wall = time.perf_counter() - t0
                break
            except TransientFault:
                attempt += 1
                if attempt > self.retry_limit:
                    self._abort_prefill(slot, "error", self.clock.now())
                    return
                st.metrics.retries += 1
                self._backoff(attempt)
            except PermanentFault:
                self._abort_prefill(slot, "error", self.clock.now())
                return
        st.done = end
        self._queue.note_prefill(slot)
        self.step_log.append(StepRecord(
            step=self._step_i, n_active=len(self.active),
            collective_counts=dict(self._chunk_counts),
            predicted_wire_bytes=sum(
                o.wire_bytes
                for o in self.backend.chunk_comm_ops(end - start)),
            measured_transfers=self.backend.drain_transfers(),
            phase="prefill" if st.resume is None else "recompute",
            rid=st.req.rid,
            prefix_len=None if st.resume is None else len(st.prefix),
            cached_prefix_len=st.cached or None,
            wall_s=wall))
        self._step_i += 1
        if end < len(st.prefix):
            return
        del self.prefilling[slot]
        self.backend.finish_prefill(slot)
        now = self.clock.now()
        self._adm_seq += 1
        if st.resume is not None:
            self._resume_active(slot, st.req, st.metrics, st.resume,
                                len(st.prefix), int(tok))
            return
        self._start_decoding(slot, st.req, st.metrics, int(tok), now)

    # ------------------------------------------------------------- stepping
    def _error_active(self, why: str) -> None:
        now = self.clock.now()
        for slot in list(self.active):
            self._finish(slot, "error", now)

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

    def _pump_queue(self) -> Optional[List[RoundResult]]:
        """Refill and pump the instruction queue behind the recovery
        ladder: preemption on pool exhaustion, bounded backoff retries on
        transient faults, error-finish and queue abort on permanent ones.
        Each attempt draws pp_transfer (p > 1), pool, decode in that
        order, so a seeded schedule hits the same sites as the reference's.
        Returns the completed rounds, or None when this iteration's decode
        was abandoned."""
        attempt = 0
        while True:
            try:
                if self.faults is not None:
                    if self.backend.p > 1:
                        self._apply_fault("pp_transfer")
                    self._apply_fault("pool")
                    self._apply_fault("decode")
                self._refill_rounds()
                if not self._queue.in_flight:
                    return None
                return self._queue.pump()
            except MemoryError:
                if len(self.active) < 2:
                    # nothing else to preempt (the pages are held by
                    # mid-prefill slots, or the fault was injected): stall
                    # this iteration instead of thrashing the lone request
                    return None
                self._preempt_youngest()
            except TransientFault:
                attempt += 1
                if attempt > self.retry_limit:
                    self._error_active("retries exhausted")
                    self._queue.abort_all()
                    return None
                for st in self.active.values():
                    st.metrics.retries += 1
                self._backoff(attempt)
            except PermanentFault:
                self._error_active("permanent fault")
                self._queue.abort_all()
                return None

    def _complete_round(self, res: RoundResult) -> None:
        """Record one decode round and append its tokens to the slots that
        are still active (``n_active``: the rows the round appends to; a
        slot preempted or cancelled mid-round is skipped)."""
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
            elif self._expired(st.req, now, pre_first_token=False):
                self._finish(slot, "deadline", now)

    def _drain_queue(self) -> None:
        """Complete every in-flight round (the ``Sync`` instruction) before
        a prefill or a cancellation touches caches or pages a round may
        still read; the rounds' hops were charged to them, so the transfer
        cursor moves on past them."""
        drained = bool(self._queue.in_flight)
        for res in self._queue.sync():
            self._complete_round(res)
        if drained:
            self.backend.drain_transfers()

    def step(self) -> bool:
        """One scheduler iteration; returns False when fully drained."""
        if not self.queue and not self.active and not self.prefilling \
                and not self._queue.in_flight:
            return False
        self._shed_expired(self.clock.now())
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
        results = self._pump_queue()
        if results is None:
            return self._next(True)
        for res in results:
            self._complete_round(res)
        return self._next(bool(self.queue or self.active or self.prefilling
                               or self._queue.in_flight))

    def _next(self, more: bool) -> bool:
        """Stall guard: a live scheduler changes something every iteration;
        a signature frozen for 10000 iterations is a logic error (or an
        injector that faults every draw)."""
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


def serve(backend: DecodeBackend, requests: Sequence[Request],
          clock=None) -> ServingReport:
    """One-shot convenience wrapper: schedule ``requests`` to completion."""
    return Scheduler(backend, clock=clock).run(requests)


# ---------------------------------------------------------------------------
# disaggregated prefill/decode pools
# ---------------------------------------------------------------------------


class _ShiftedClock:
    """The decode pool's clock when both pools run in one process: the
    base clock minus every second the prefill pool has spent computing and
    shipping pages, so decode-side TTFT/TPOT read as if the prefill pool
    were a machine of its own.  On a ``VirtualClock`` the offset stays 0
    and the two timelines coincide."""

    def __init__(self, base):
        self.base = base
        self.offset = 0.0

    def now(self) -> float:
        return self.base.now() - self.offset

    def wait_until(self, t: float) -> None:
        self.base.wait_until(t + self.offset)


@dataclasses.dataclass
class HandoffRecord:
    """One request's prefill->decode KV handoff, predicted beside measured.

    ``queue_s`` and ``prefill_s`` are on the BASE clock (the prefill pool's
    timeline); ``submitted`` is the decode-clock instant the request joined
    the decode pool's queue — its rewritten arrival."""

    rid: int
    pages: int                # full prompt blocks shipped (kv_handoff_pages)
    bytes: int                # measured: device bytes import_page wrote
    predicted_bytes: float    # commodel.kv_handoff_ops
    queue_s: float            # arrival -> prefill start on the prefill pool
    prefill_s: float          # prefill-pool busy span (compute + page ship)
    submitted: float          # decode-clock arrival at the decode pool
    first_token: int          # the prefill pool's final-position greedy
    #                           token, held equal to the decode pool's first


@dataclasses.dataclass
class DisaggReport:
    """A disaggregated run: the decode pool's ServingReport (every
    per-request metric, on the decode clock) and the handoff ledger;
    phase "handoff" StepRecords are among ``decode.steps``."""

    decode: ServingReport
    handoffs: List[HandoffRecord]
    wall_time: float          # base-clock span: prefill + ship + decode

    @property
    def metrics(self) -> List[RequestMetrics]:
        return self.decode.metrics

    @property
    def total_tokens(self) -> int:
        return self.decode.total_tokens

    def tokens_by_rid(self) -> Dict[int, List[int]]:
        return self.decode.tokens_by_rid()

    @property
    def handoff_pages(self) -> int:
        return sum(h.pages for h in self.handoffs)

    @property
    def handoff_bytes(self) -> int:
        return sum(h.bytes for h in self.handoffs)

    def summary(self) -> dict:
        out = self.decode.summary()
        queue = [h.queue_s for h in self.handoffs]
        out["disagg"] = {
            "handoffs": len(self.handoffs),
            "handoff_pages": self.handoff_pages,
            "handoff_bytes": self.handoff_bytes,
            "predicted_handoff_bytes": float(
                sum(h.predicted_bytes for h in self.handoffs)),
            "prefill_pool_busy_s": float(
                sum(h.prefill_s for h in self.handoffs)),
            "prefill_queue_p95_s": float(np.percentile(queue, 95))
            if queue else 0.0,
            "base_wall_time_s": self.wall_time,
        }
        return out


class DisaggScheduler:
    """Two backends, one serving plane: a prefill pool and a decode pool.

    Fresh prompts of ``route_prompt_len`` or more tokens go to the prefill
    pool (one whole batch-1 prefill at a time, in slot 0); shorter ones go
    straight to the decode pool (a ``Scheduler`` over a paged,
    prefix-cached backend).  When the prefill pool has prefilled a prompt,
    its full blocks ship page by page (``export_page`` -> ``import_page``,
    device bytes measured), are then pinned into the SHARED prefix index
    (``cache_prefix``), the prefill slot is freed, and the request is
    submitted to the decode pool, whose cache-aware admission hits on the
    blocks and prefills at most the last partial page.

    Each handoff logs a phase "handoff" StepRecord; its measured bytes
    must equal ``commodel.kv_handoff_ops`` (pages x kv_page_bytes), and
    the decode pool's first streamed token must equal the greedy token the
    prefill pool computed at the prompt's last position — both
    ``RuntimeError``s otherwise.

    The decode pool runs on a ``_ShiftedClock`` that subtracts the
    prefill pool's busy time; a handed-off request's arrival is rewritten
    to the handoff's end on that clock (its prefill-side latency lives in
    its ``HandoffRecord``), so deadlines apply per pool.
    """

    def __init__(self, prefill_backend: DecodeBackend,
                 decode_backend: DecodeBackend, clock=None,
                 chunk_size: int = None, admission: str = "conservative",
                 faults=None, route_prompt_len: Optional[int] = None,
                 retry_limit: int = 3, retry_backoff: float = 0.05):
        if not getattr(prefill_backend, "paged", False) \
                or not getattr(decode_backend, "paged", False):
            raise ValueError(
                "disaggregated pools hand KV off as pages — construct BOTH "
                "backends with paged=True")
        if decode_backend.prefix_index is None:
            raise ValueError(
                "the decode pool admits handed-off requests through its "
                "prefix index — construct the decode backend with "
                "prefix_cache=True")
        if prefill_backend.pool is not decode_backend.pool:
            raise ValueError(
                "disaggregated pools must share ONE KVPool (construct the "
                "prefill backend with pool=decode_backend.pool) — the "
                "handoff names pages of a common address space")
        pr = (prefill_backend._owner_base,
              prefill_backend._owner_base + prefill_backend.num_slots)
        dr = (decode_backend._owner_base,
              decode_backend._owner_base + decode_backend.num_slots)
        if max(pr[0], dr[0]) < min(pr[1], dr[1]):
            raise ValueError(
                f"pool-sharing backends need disjoint owner ranges, got "
                f"{pr} and {dr} — construct one with "
                f"owner_base=<the other's num_slots>")
        if prefill_backend.cfg is not decode_backend.cfg \
                and prefill_backend.cfg != decode_backend.cfg:
            raise ValueError(
                "both pools must serve the same model config — cross-pool "
                "token identity is asserted per request")
        self.prefill_backend = prefill_backend
        self.decode_backend = decode_backend
        # one index, both pools: the prefill pool inserts finished prompts
        # (and may evict cold entries under page pressure), the decode pool
        # hits on them at admission
        prefill_backend.prefix_index = decode_backend.prefix_index
        self.index = decode_backend.prefix_index
        self.base_clock = clock if clock is not None else WallClock()
        self._dclock = _ShiftedClock(self.base_clock)
        self.decode = Scheduler(decode_backend, clock=self._dclock,
                                chunk_size=chunk_size, admission=admission,
                                faults=faults, retry_limit=retry_limit,
                                retry_backoff=retry_backoff)
        ps = decode_backend.page_size
        self.route_prompt_len = (2 * ps if route_prompt_len is None
                                 else int(route_prompt_len))
        if self.route_prompt_len < ps:
            raise ValueError(
                f"route_prompt_len {self.route_prompt_len} < page_size "
                f"{ps}: a prompt with no full block has nothing to hand "
                f"off — the decode pool would cold-prefill it anyway")
        self.faults = faults
        self.retry_limit = int(retry_limit)
        self.retry_backoff = float(retry_backoff)
        self.pending: List[Request] = []      # prefill-pool queue, by arrival
        self.handoffs: List[HandoffRecord] = []
        self.finished_prefill: List[RequestMetrics] = []  # shed/errored here
        self._expected_first: Dict[int, int] = {}
        self._pre_retries: Dict[int, int] = {}
        self._rids: set = set()
        self._b = torch_dtype(decode_backend.cfg.dtype).itemsize

    # ------------------------------------------------------------- intake
    def submit(self, requests) -> None:
        """Route: prompts of ``route_prompt_len``+ tokens queue for the
        prefill pool, the rest go straight to the decode pool.  A routed
        request is checked against BOTH pools now, so one that could never
        fit fails here, not at its handoff."""
        reqs = [requests] if isinstance(requests, Request) else list(requests)
        routed: List[Request] = []
        for r in reqs:
            if r.rid in self._rids:
                raise ValueError(
                    f"duplicate rid {r.rid}: already submitted this run")
            self._rids.add(r.rid)
            if r.prompt_len >= self.route_prompt_len:
                routed.append(r)
            else:
                self.decode.submit(r)
        pb, db = self.prefill_backend, self.decode_backend
        usable = db.pool.num_pages - 1          # minus the scratch page
        for r in routed:
            pre_len = pb._alloc_len(r.prompt_len)
            if pre_len > pb.max_len:
                raise ValueError(
                    f"request {r.rid} prompt ({pre_len} CP-padded "
                    f"positions) > prefill pool max_len {pb.max_len}")
            need = r.prompt_len + r.max_new_tokens - 1
            if need > db.max_len:
                raise ValueError(
                    f"request {r.rid} needs {need} cache positions > "
                    f"decode pool max_len {db.max_len}")
            need_pages = max(-(-pre_len // pb.page_size),
                             -(-need // db.page_size))
            if need_pages > usable:
                raise ValueError(
                    f"request {r.rid} needs {need_pages} pages > shared "
                    f"pool capacity {usable}")
            bisect.insort(self.pending, r, key=lambda x: x.arrival)

    def cancel(self, rid: int) -> bool:
        """Cancel wherever the request is — the prefill pool's queue or
        anywhere inside the decode pool."""
        for req in self.pending:
            if req.rid == rid:
                self.pending.remove(req)
                self._fail(req, "cancelled")
                return True
        return self.decode.cancel(rid)

    # ------------------------------------------------------------- faults
    def _apply_fault(self, site: str) -> None:
        """Prefill-pool fault draws on the BASE clock: a delay stretches
        the prefill pool's timeline (and so the clock offset), never the
        decode pool's."""
        if self.faults is None:
            return
        f = self.faults.draw(site)
        if f is None:
            return
        if f.kind == "delay":
            self.base_clock.wait_until(self.base_clock.now() + f.delay_s)
        elif f.kind == "oom":
            raise MemoryError(f"injected fault at {site}")
        elif f.kind == "transient":
            raise TransientFault(f"injected fault at {site}")
        else:
            raise PermanentFault(f"injected fault at {site}")

    def _backoff(self, attempt: int) -> None:
        self.base_clock.wait_until(
            self.base_clock.now()
            + self.retry_backoff * 2.0 ** (attempt - 1))

    def _fail(self, req: Request, reason: str) -> None:
        """Finish a request on the prefill side (shed, cancelled or errored
        before its handoff): a metrics row with no tokens, on the base
        clock."""
        m = RequestMetrics(rid=req.rid, prompt_len=req.prompt_len,
                           arrival=req.arrival)
        m.retries = self._pre_retries.pop(req.rid, 0)
        m.finished = self.base_clock.now()
        m.finish_reason = reason
        self.finished_prefill.append(m)

    def _shed_pending(self, now: float) -> None:
        for req in [r for r in self.pending
                    if Scheduler._expired(r, now, True)]:
            self.pending.remove(req)
            self._fail(req, "deadline")

    # ------------------------------------------------------------- handoff
    def _prefill_arrived(self, now: float) -> bool:
        """Prefill and hand off every pending request that has arrived, in
        arrival order.  True if anything happened."""
        did = False
        while self.pending and self.pending[0].arrival <= now:
            if not self._prefill_one(self.pending[0]):
                break                     # deferred on pool pressure
            did = True
            now = self.base_clock.now()
            self._shed_pending(now)       # the pass moved the clock
        return did

    def _prefill_one(self, req: Request) -> bool:
        """One whole prefill and its page handoff.  False when the request
        was deferred (the shared pool is exhausted while the decode pool
        still holds pages: retried next iteration), True otherwise."""
        be = self.prefill_backend
        t_start = self.base_clock.now()
        try:
            # slot 0: the prefill pool runs one batch-1 pass at a time
            be.begin_prefill(0, req.prompt_len, 1)
        except MemoryError:
            # the pool is exhausted and the index drained: wait for the
            # decode pool to free pages — unless it is idle too, and the
            # pages do not exist
            if (self.decode.active or self.decode.prefilling
                    or self.decode._queue.in_flight):
                return False
            self.pending.remove(req)
            self._fail(req, "error")
            return True
        self.pending.remove(req)
        queue_s = max(0.0, t_start - req.arrival)
        attempt = 0
        while True:
            try:
                self._apply_fault("prefill")
                tok = be.prefill_whole(0, req.prompt)
                break
            except (TransientFault, MemoryError):
                # an injected prefill oom retries too: the slot's pages are
                # claimed, and prefilling them again is idempotent
                attempt += 1
                if attempt > self.retry_limit:
                    be.free_slots([0])
                    self._fail(req, "error")
                    return True
                self._pre_retries[req.rid] = \
                    self._pre_retries.get(req.rid, 0) + 1
                self._backoff(attempt)
            except PermanentFault:
                be.free_slots([0])
                self._fail(req, "error")
                return True
        # ship the full blocks BEFORE indexing them: an index entry must
        # never name a page whose decode-side content has not landed
        n_pages = kv_handoff_pages(req.prompt_len, be.page_size)
        table = [int(p) for p in
                 be.pool.block_table(be._owner(0))[:n_pages]]
        measured, shipped, attempt = 0, 0, 0
        while shipped < len(table):
            try:
                self._apply_fault("handoff")
                pg = table[shipped]
                measured += self.decode_backend.import_page(
                    pg, be.export_page(pg))
                shipped += 1
            except TransientFault:
                attempt += 1
                if attempt > self.retry_limit:
                    be.free_slots([0])
                    self._fail(req, "error")
                    return True
                self._pre_retries[req.rid] = \
                    self._pre_retries.get(req.rid, 0) + 1
                self._backoff(attempt)
            except PermanentFault:
                be.free_slots([0])
                self._fail(req, "error")
                return True
        be.cache_prefix(0, req.prompt)        # pins the shipped pages
        hit = self.index.lookup(np.asarray(req.prompt, np.int32))
        # a lookup is capped one position short, so a block-aligned prompt
        # hits one block fewer than it shipped; that page stays pinned for
        # later prompts sharing the prefix
        if list(hit.pages) != table[:len(hit.pages)] \
                or len(hit.pages) < n_pages - 1:
            raise RuntimeError(
                f"handoff pages diverged for rid {req.rid}: shipped "
                f"{table}, index holds {list(hit.pages)}")
        be.free_slots([0])
        elapsed = self.base_clock.now() - t_start
        # the decode clock does not see the prefill pool's busy span
        self._dclock.offset += elapsed
        submitted = self._dclock.now()
        ops = kv_handoff_ops(be.cfg, n_pages, be.page_size, b=self._b)
        predicted = sum(o.wire_bytes for o in ops)
        if measured != int(predicted):
            raise RuntimeError(
                f"handoff bytes diverged for rid {req.rid}: measured "
                f"{measured} != predicted {int(predicted)} "
                f"({n_pages} pages × kv_page_bytes)")
        self.decode.step_log.append(StepRecord(
            step=self.decode._step_i, n_active=len(self.decode.active),
            collective_counts=_count(ops),
            predicted_wire_bytes=predicted,
            measured_transfers={"count": n_pages, "bytes": measured},
            phase="handoff", rid=req.rid,
            prefix_len=n_pages * be.page_size, wall_s=elapsed))
        self.handoffs.append(HandoffRecord(
            rid=req.rid, pages=n_pages, bytes=measured,
            predicted_bytes=predicted, queue_s=queue_s, prefill_s=elapsed,
            submitted=submitted, first_token=int(tok)))
        self._expected_first[req.rid] = int(tok)
        self.decode.submit(dataclasses.replace(req, arrival=submitted))
        return True

    # ------------------------------------------------------------- driving
    def run(self, requests=None) -> DisaggReport:
        """Drive both pools until every submitted request has finished."""
        t0 = self.base_clock.now()
        d0 = self._dclock.now()
        if requests is not None:
            self.submit(requests)
        while True:
            now = self.base_clock.now()
            self._shed_pending(now)
            progressed = self._prefill_arrived(now)
            decode_idle = (not self.decode.active
                           and not self.decode.prefilling
                           and not self.decode._queue.in_flight)
            if decode_idle and self.pending and not progressed:
                # the decode pool would wait for ITS next arrival; if the
                # prefill pool's next request is due sooner on the base
                # clock, move there instead
                next_dec = (self.decode.queue[0].arrival
                            + self._dclock.offset
                            if self.decode.queue else float("inf"))
                if self.pending[0].arrival <= next_dec:
                    self.base_clock.wait_until(self.pending[0].arrival)
                    continue
            alive = self.decode.step()
            if not alive and not self.pending:
                break
        # fold prefill-side retries into the decode-side metrics rows
        metrics = sorted(self.decode.finished + self.finished_prefill,
                         key=lambda m: m.rid)
        for m in metrics:
            m.retries += self._pre_retries.pop(m.rid, 0)
        # cross-pool identity: greedy decode is deterministic, so a
        # divergence means the handed-off K/V is not what the decode pool
        # would have written itself
        for m in metrics:
            exp = self._expected_first.get(m.rid)
            if exp is not None and m.tokens and m.tokens[0] != exp:
                raise RuntimeError(
                    f"cross-pool token divergence for rid {m.rid}: decode "
                    f"pool streamed {m.tokens[0]}, prefill pool computed "
                    f"{exp} — handed-off KV differs from native prefill")
        dec = ServingReport(metrics=metrics, steps=self.decode.step_log,
                            wall_time=self._dclock.now() - d0)
        report = DisaggReport(decode=dec, handoffs=self.handoffs,
                              wall_time=self.base_clock.now() - t0)
        self.decode.finished, self.decode.step_log = [], []
        self.decode._step_i = 0
        self.decode._rids = set()
        self.decode._last_sig, self.decode._idle_iters = None, 0
        self.handoffs, self.finished_prefill = [], []
        self._expected_first, self._pre_retries = {}, {}
        self._rids = set()
        return report
