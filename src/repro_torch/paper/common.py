"""Shared helpers of the paper's tables and figures.

Every module of ``repro_torch.paper`` exposes ``rows() -> list[(name,
us_per_call, derived)]`` where ``us_per_call`` is the measured wall time
of producing the quantity and ``derived`` is its headline number (a
count, byte volume, ms, …).  ``repro_torch.paper.run`` aggregates all
modules into one CSV.  Counterpart of ``benchmarks/common.py``.
"""
from __future__ import annotations

import time
from typing import Callable, Tuple

Row = Tuple[str, float, str]


def timed(fn: Callable, repeat: int = 5):
    """Return (result, mean_us)."""
    fn()                                    # warmup
    t0 = time.perf_counter()
    for _ in range(repeat):
        out = fn()
    us = (time.perf_counter() - t0) / repeat * 1e6
    return out, us


def fmt_bytes(b: float) -> str:
    return f"{b / 2**20:.2f}MiB"
