"""Deterministic seeded fault injection for the serving layer (DESIGN.md §10).

The paper's SLO study is about service quality under real-world conditions;
a real-world serving stack also has to *survive* them.  This module is the
harness the scheduler's recovery paths are tested against: a seeded source
of faults injected at named instrumentation sites, so a chaos run is exactly
reproducible from ``(seed, rates)`` and a unit test can script the precise
step a fault lands on.

Sites (drawn by the scheduler, ``runtime/scheduler.py``):

  ``decode``       before the fused decode step — a transient fault models a
                   recoverable step failure (retried with backoff), a
                   permanent one a dead engine (active requests finish with
                   ``finish_reason="error"``).
  ``prefill``      before a prefill pass / chunk — same taxonomy, scoped to
                   the one admitting/prefilling request.
  ``pool``         an injected ``MemoryError`` standing in for KV-pool
                   exhaustion mid-decode — exercises preemption-by-recompute
                   exactly like a real ``KVPool.extend`` failure.
  ``pp_transfer``  a pipeline boundary hop delayed (latency spike, applied
                   to the scheduler clock) or failed (transient, retried);
                   only drawn when the backend has p > 1.

Faults are *drawn*, never ambient: each ``draw(site)`` advances a
deterministic per-site counter and an rng stream derived from ``(seed,
site)``, so the fault schedule is a pure function of the call sequence —
independent of wall time, and independent across sites (adding draws at one
site never shifts another site's schedule).  ``FaultInjector.scripted``
pins faults to exact (site, nth-call) coordinates for regression tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


class TransientFault(RuntimeError):
    """A recoverable failure: the operation may succeed if retried."""


class PermanentFault(RuntimeError):
    """An unrecoverable failure: retrying cannot help."""


SITES = ("decode", "prefill", "pool", "pp_transfer", "handoff")

# how an injected fault at each site manifests, and with what weight the
# random mode picks each kind (delays only exist at the transfer sites —
# a slow boundary hop or a slow KV-page ship is a latency spike, not an
# exception; "handoff" is the disaggregated prefill→decode page transfer,
# DESIGN.md §14)
_KINDS = {
    "decode": ("transient", "permanent"),
    "prefill": ("transient", "permanent"),
    "pool": ("oom",),
    "pp_transfer": ("delay", "transient"),
    "handoff": ("delay", "transient", "permanent"),
}


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected fault: what happens when the scheduler draws it."""

    site: str
    kind: str                  # "transient" | "permanent" | "oom" | "delay"
    delay_s: float = 0.0       # latency spike (kind == "delay" only)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}")
        if self.kind not in _KINDS[self.site]:
            raise ValueError(
                f"site {self.site!r} cannot inject kind {self.kind!r} "
                f"(allowed: {_KINDS[self.site]})")


class FaultInjector:
    """Seeded random fault schedule over the instrumentation sites.

    ``rates`` maps site -> per-draw fault probability (unlisted sites never
    fault).  ``transient_frac`` splits decode/prefill faults between
    transient and permanent; ``delay_frac`` splits pp_transfer faults
    between latency spikes of ``delay_s`` seconds and transient failures.
    ``max_faults`` bounds the total injections (a finite chaos schedule is
    what makes "the scheduler always terminates" a theorem rather than a
    probability-1 statement).

    Every draw is logged in ``injected`` as (site, call_index, Fault) so a
    test can assert exactly which faults a run absorbed.
    """

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, float]] = None,
                 transient_frac: float = 0.9, delay_frac: float = 0.5,
                 delay_s: float = 10e-3,
                 max_faults: Optional[int] = 64):
        rates = dict(rates or {})
        for site in rates:
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r}; "
                                 f"sites are {SITES}")
        self.rates = rates
        self.transient_frac = float(transient_frac)
        self.delay_frac = float(delay_frac)
        self.delay_s = float(delay_s)
        self.max_faults = max_faults
        self.seed = int(seed)
        # independent stream per site: draws at one site never perturb
        # another site's schedule
        self._rngs = {site: np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed, spawn_key=(i,)))
            for i, site in enumerate(SITES)}
        self._calls = {site: 0 for site in SITES}
        self.injected: List[Tuple[str, int, Fault]] = []

    # ------------------------------------------------------------------
    def _pick_kind(self, site: str, u: float) -> Fault:
        if site == "pool":
            return Fault(site, "oom")
        if site == "pp_transfer":
            if u < self.delay_frac:
                return Fault(site, "delay", delay_s=self.delay_s)
            return Fault(site, "transient")
        kind = "transient" if u < self.transient_frac else "permanent"
        return Fault(site, kind)

    def draw(self, site: str) -> Optional[Fault]:
        """Advance ``site``'s schedule one step; returns the fault to
        inject at this call, or None."""
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}")
        idx = self._calls[site]
        self._calls[site] += 1
        rng = self._rngs[site]
        # always burn exactly two uniforms per draw so the site's schedule
        # depends only on its own call count
        u_fault, u_kind = rng.random(), rng.random()
        if self.max_faults is not None and \
                len(self.injected) >= self.max_faults:
            return None
        if u_fault >= self.rates.get(site, 0.0):
            return None
        fault = self._pick_kind(site, u_kind)
        self.injected.append((site, idx, fault))
        return fault

    # ------------------------------------------------------------------
    @classmethod
    def scripted(cls, plan: Dict[Tuple[str, int], Fault]) -> "FaultInjector":
        """Deterministic injector: fault exactly at the given
        (site, nth-call-at-that-site) coordinates, nowhere else."""
        inj = cls(seed=0, rates={})
        inj._plan = {}
        for (site, idx), fault in plan.items():
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r}")
            if fault.site != site:
                raise ValueError(
                    f"fault site {fault.site!r} does not match key {site!r}")
            inj._plan[(site, idx)] = fault

        def draw(site: str) -> Optional[Fault]:
            idx = inj._calls[site]
            inj._calls[site] += 1
            fault = inj._plan.get((site, idx))
            if fault is not None:
                inj.injected.append((site, idx, fault))
            return fault

        inj.draw = draw                      # type: ignore[method-assign]
        return inj
