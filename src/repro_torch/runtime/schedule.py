"""Instruction queue the scheduler drains and refills.

Counterpart of ``repro.runtime.schedule`` for the fused backends: the
single-device ``decode_step`` wrapped as a degenerate one-instruction queue
(``FusedQueue``), so the scheduler protocol is the one the pipeline
backends will plug into.  ``DynamicPPQueue``, which fills the pipeline
decode bubble, waits for the PP engines (ROADMAP item A5).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class RoundResult:
    """One completed decode round: ``tokens[i]`` belongs to ``slots[i]``.
    ``ticks``/``stage_busy``/``stage_idle`` are deltas of the queue's
    schedule clock; ``transfers`` counts the round's own boundary hops."""
    mb: int
    slots: List[int]
    tokens: np.ndarray
    transfers: Dict[str, int]
    wall_s: float
    ticks: int
    stage_busy: List[int]
    stage_idle: List[int]


class FusedQueue:
    """The fused ``decode_step`` as a one-instruction queue (group 0 spans
    every slot)."""

    def __init__(self, backend):
        self.backend = backend
        self.group_size = int(backend.num_slots)
        self._round = None

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
        tr = self.backend.drain_transfers()
        return [RoundResult(
            mb=g, slots=list(range(self.group_size)),
            tokens=np.asarray(nxt, np.int32), transfers=dict(tr),
            wall_s=wall, ticks=1, stage_busy=[1], stage_idle=[0])]

    def sync(self) -> List[RoundResult]:
        """Complete the pending round, if any, before a cache/page write."""
        return self.pump()


def make_queue(backend):
    """The instruction queue of ``backend``, resolved through its class (a
    proxy that delegates attributes keeps the queue bound to the proxy); a
    class without ``make_queue`` gets the fused queue."""
    mk = getattr(type(backend), "make_queue", None)
    if mk is None:
        return FusedQueue(backend)
    return mk(backend)
