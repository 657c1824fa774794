"""Three-term roofline of one step of the port.

Counterpart of ``repro.core.roofline``, with the port's numerators:

    compute    = FLOPs       / (peak FLOP/s)
    memory     = HBM bytes   / (HBM bytes/s)
    collective = wire bytes  / (link bytes/s)

per chip.  FLOPs and bytes come from ``core.op_cost`` (a walk of the
step's ATen ops on meta tensors, where JAX's come from compiled HLO;
its ``min_bytes``, the compulsory traffic, makes the memory term a lower
bound, its ``bytes`` an eager-traffic estimate);
the collectives from a comm log's ``summary()`` (``core.comm``) or a
``hlo_comm.summarize``-shaped dict {kind: {count, msg_bytes,
wire_bytes}}.  Wire bytes follow ``hlo_comm``'s factors (below).
MODEL_FLOPS is 6·N·D (train) or 2·N·D (prefill, and 2·N·B a decode
step), N the active parameter count.  The default hardware is
``H100_NODE``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.config.base import (H100_NODE, HardwareProfile,
                                     ModelConfig, ShapeConfig)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    coll_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_total: float
    useful_ratio: float
    collectives: Dict[str, dict]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> str:
        return (f"{self.arch:18s} {self.shape:12s} {self.mesh:10s} "
                f"C {self.compute_s*1e3:9.3f} ms  M {self.memory_s*1e3:9.3f} ms  "
                f"K {self.collective_s*1e3:9.3f} ms  dom={self.dominant:10s} "
                f"useful={self.useful_ratio:6.3f}")


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D (train) / 2·N·D (prefill) / 2·N·B (per decode step), active
    N."""
    n = cfg.active_param_count()
    if shape.mode == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.mode == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch          # one decode step


def wire_factor(kind: str, d: int) -> float:
    """``hlo_comm``'s wire factors on the message (the result side):
    all-reduce 2(d-1)/d, all-gather and all-to-all (d-1)/d,
    reduce-scatter d-1 (of its output), collective-permute (and a send)
    1."""
    d = max(int(d), 1)
    if kind == "allreduce":
        return 2.0 * (d - 1) / d
    if kind in ("allgather", "alltoall"):
        return (d - 1) / d
    if kind == "reducescatter":
        return float(d - 1)
    return 1.0


def summarize_ops(ops) -> Dict[str, dict]:
    """``CommOp`` rows (a comm log's ``summary()``) in
    ``hlo_comm.summarize``'s form.  A reduce-scatter's message is its
    output, 1/d of the input the log records."""
    out: Dict[str, dict] = {}
    for op in ops:
        msg = op.total_msg_bytes
        if op.collective == "reducescatter":
            msg = msg / op.workers
        row = out.setdefault(op.collective, {"count": 0, "msg_bytes": 0,
                                             "wire_bytes": 0.0})
        row["count"] += op.count
        row["msg_bytes"] += msg
        row["wire_bytes"] += msg * wire_factor(op.collective, op.workers)
    return out


def analyze(cfg: ModelConfig, shape: ShapeConfig, mesh_name: str,
            n_chips: int, flops: float, hbm_bytes: float,
            collectives=None,
            hw: HardwareProfile = H100_NODE) -> RooflineReport:
    """The report of one step: ``flops`` and ``hbm_bytes`` per chip (from
    ``op_cost``), ``collectives`` a comm log's ``CommOp`` rows or a
    summarize-shaped dict (None: no collectives)."""
    if collectives is None:
        collectives = {}
    elif not isinstance(collectives, dict):
        collectives = summarize_ops(collectives)
    coll_bytes = sum(c["wire_bytes"] for c in collectives.values())
    mf = model_flops(cfg, shape)
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, n_chips=n_chips,
        flops_per_chip=flops, hbm_bytes_per_chip=hbm_bytes,
        coll_bytes_per_chip=coll_bytes,
        compute_s=flops / hw.peak_flops,
        memory_s=hbm_bytes / hw.hbm_bw,
        collective_s=coll_bytes / hw.intra_bw,
        model_flops_total=mf,
        useful_ratio=(mf / (flops * n_chips)) if flops else 0.0,
        collectives=collectives,
    )
