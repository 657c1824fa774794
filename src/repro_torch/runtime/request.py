"""Serving requests and per-request SLO metrics (paper §V-C, request level).

The paper's SLO study is about *serving*: requests with distinct arrival
times, prompt lengths and decode budgets.  This module is the request-level
vocabulary the continuous-batching scheduler (runtime/scheduler.py) consumes:
a :class:`Request` (prompt + decode budget + arrival time + optional
deadlines), the :class:`RequestMetrics` record (TTFT / TPOT / E2E — the
paper's Fig. 8–10 quantities, measured instead of predicted), and a Poisson
trace generator for benchmarks/serving_bench.py.

Finish-reason taxonomy (DESIGN.md §10):

  ``"length"``     decode budget exhausted (``max_new_tokens``) — normal.
  ``"eos"``        the model emitted ``eos_id`` (or the emulated early stop
                   ``eos_pos`` was reached) — normal, early.
  ``"deadline"``   shed: the request could no longer meet its
                   ``deadline`` / ``ttft_deadline``; tokens generated so
                   far are kept.
  ``"cancelled"``  shed by an explicit ``Scheduler.cancel(rid)``.
  ``"error"``      a permanent fault (or exhausted retries) killed the
                   request mid-flight.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One inference request.

    ``arrival`` is in seconds relative to the start of the scheduler run
    (0.0 = queued before the run starts).  ``eos_id`` stops decode early when
    the model emits it; ``max_new_tokens`` always bounds the decode length
    (first token from prefill included).

    ``eos_pos`` is the *emulated* early stop: finish with reason "eos" after
    that many generated tokens.  Synthetic traces need it because greedy
    streams from randomly-initialized weights have no designated EOS token —
    it exercises the exact same early-eviction path (the one that strands
    conservative-admission capacity, DESIGN.md §10) with a deterministic,
    trace-controlled stop.

    ``deadline`` / ``ttft_deadline`` are SLO budgets in seconds *relative to
    arrival*: miss either and the scheduler sheds the request mid-flight
    with ``finish_reason="deadline"`` instead of spending capacity on an
    answer nobody is waiting for.
    """

    rid: int
    prompt: np.ndarray               # [S] int32 token ids
    max_new_tokens: int
    arrival: float = 0.0
    eos_id: Optional[int] = None
    eos_pos: Optional[int] = None    # emulated EOS after N generated tokens
    deadline: Optional[float] = None       # E2E budget, seconds from arrival
    ttft_deadline: Optional[float] = None  # first-token budget, from arrival

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")
        if self.eos_pos is not None and self.eos_pos < 1:
            raise ValueError(f"request {self.rid}: eos_pos < 1")
        for name in ("deadline", "ttft_deadline"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"request {self.rid}: {name} must be > 0")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclasses.dataclass
class RequestMetrics:
    """Measured per-request SLOs — the serving counterpart of
    ``core.slo.predict_slo`` (which predicts the same three quantities
    analytically for a single request on an idle engine)."""

    rid: int
    prompt_len: int
    arrival: float
    admitted: float = 0.0            # FIRST prefill start (queue delay ends)
    first_token: float = 0.0         # TTFT reference point
    finished: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reason: str = ""          # taxonomy in the module docstring
    preemptions: int = 0             # times evicted + recomputed (§10)
    retries: int = 0                 # transient-fault retries while active
    cached_prefix_len: int = 0       # prefix-cache hit at admission: prompt
    #                                  positions adopted, not computed (§13)

    @property
    def num_generated(self) -> int:
        return len(self.tokens)

    @property
    def ttft(self) -> float:
        return self.first_token - self.arrival

    @property
    def queue_delay(self) -> float:
        return self.admitted - self.arrival

    @property
    def tpot(self) -> float:
        """Mean time per output token after the first (0 for 1-token runs)."""
        if self.num_generated <= 1:
            return 0.0
        return (self.finished - self.first_token) / (self.num_generated - 1)

    @property
    def e2e(self) -> float:
        return self.finished - self.arrival

    def row(self) -> str:
        return (f"req {self.rid:3d}  s_p {self.prompt_len:4d} "
                f"n_out {self.num_generated:4d}  "
                f"TTFT {self.ttft*1e3:8.1f} ms  TPOT {self.tpot*1e3:7.2f} ms  "
                f"E2E {self.e2e:6.3f} s  [{self.finish_reason}]")


def make_poisson_trace(n_requests: int, rate: float, vocab_size: int,
                       prompt_lens=(8, 64), decode_lens=(4, 32),
                       seed: int = 0, quantum: int = 1,
                       eos_prob: float = 0.0) -> List[Request]:
    """Mixed-length request trace with Poisson arrivals at ``rate`` req/s.

    Prompt and decode lengths are drawn uniformly from the given inclusive
    ranges — the "application-specific request mix" knob the related work
    (Topcu et al.) shows flips parallelization tradeoffs.  ``rate=inf``
    (or <= 0) makes every request arrive at t=0 (closed-batch mode).
    ``quantum`` rounds prompt lengths down to a multiple (vLLM-style shape
    bucketing: each distinct prompt length compiles one batch-1 prefill).

    ``eos_prob`` makes the trace EOS-heavy: each request's emulated early
    stop (``Request.eos_pos``) is drawn geometrically with per-token stop
    probability ``eos_prob``, truncated by the decode budget — so requests
    commit their full ``max_new_tokens`` worst case at admission but mostly
    finish far earlier, exactly the mix that strands conservative-admission
    capacity (DESIGN.md §10).
    """
    rng = np.random.default_rng(seed)
    if rate and np.isfinite(rate) and rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests))
    else:
        arrivals = np.zeros(n_requests)
    if not 0.0 <= eos_prob < 1.0:
        raise ValueError(f"eos_prob must be in [0, 1), got {eos_prob}")
    reqs = []
    for i in range(n_requests):
        s_p = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        if quantum > 1:
            s_p = max(prompt_lens[0], (s_p // quantum) * quantum)
        n_d = int(rng.integers(decode_lens[0], decode_lens[1] + 1))
        eos_pos = None
        if eos_prob > 0.0:
            stop = int(rng.geometric(eos_prob))
            eos_pos = stop if stop < n_d else None
        prompt = rng.integers(2, vocab_size, s_p).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=n_d,
                            arrival=float(arrivals[i]), eos_pos=eos_pos))
    return reqs


def make_template_trace(n_requests: int, rate: float, vocab_size: int,
                        n_templates: int = 4, template_len: int = 48,
                        suffix_lens=(4, 16), decode_lens=(4, 16),
                        zipf_a: float = 1.5, seed: int = 0) -> List[Request]:
    """Template-heavy trace for the prefix cache (DESIGN.md §13): each
    prompt is a shared *template* (system prompt) of ``template_len`` tokens
    followed by a per-request unique suffix.  Templates are drawn
    zipf-distributed (exponent ``zipf_a``) over ``n_templates`` — the
    production shape where thousands of users share a handful of system
    prompts, so most requests after the first per template hit the index
    for the whole template.  Suffixes embed the rid, so no two prompts are
    identical and every hit still prefills a genuine novel suffix.
    """
    rng = np.random.default_rng(seed)
    if n_templates < 1:
        raise ValueError(f"n_templates must be >= 1, got {n_templates}")
    if not zipf_a > 1.0:
        raise ValueError(f"zipf_a must be > 1 (zipf support), got {zipf_a}")
    templates = [rng.integers(2, vocab_size, template_len).astype(np.int32)
                 for _ in range(n_templates)]
    if rate and np.isfinite(rate) and rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests))
    else:
        arrivals = np.zeros(n_requests)
    reqs = []
    for i in range(n_requests):
        t = (int(rng.zipf(zipf_a)) - 1) % n_templates
        s_s = int(rng.integers(suffix_lens[0], suffix_lens[1] + 1))
        suffix = rng.integers(2, vocab_size, s_s).astype(np.int32)
        suffix[0] = 2 + i % (vocab_size - 2)     # rid-unique: never a dup
        n_d = int(rng.integers(decode_lens[0], decode_lens[1] + 1))
        reqs.append(Request(
            rid=i, prompt=np.concatenate([templates[t], suffix]),
            max_new_tokens=n_d, arrival=float(arrivals[i])))
    return reqs
