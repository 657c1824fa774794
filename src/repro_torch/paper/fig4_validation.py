"""Paper Fig 4: measured-vs-predicted TP collectives at FULL model size.

The explicit Megatron-TP engine (``core.parallel_exec.TPModel``) runs a
128-token prefill for the paper's actual subjects (Llama-3.2-3B / 3.1-8B
/ 2-13B, full layer counts) on 4 virtual TP ranks, on meta tensors
(``launch.specs.param_sds``: nothing is allocated, no card is needed),
and the collectives its ``VirtualGroup`` logged are compared against
Eq. 1.  This is the paper's validation plot as an equality check.

Counterpart of ``benchmarks/fig4_validation.py``, which lowers the JAX
engine on a 4-device host mesh and reads the compiled HLO in a
subprocess; this one runs in-process.  One difference: JAX predicts the
all-reduce bytes at b = 4, because the CPU host backend upcasts bf16
collectives to f32.  The port's log keeps the wire's bf16, so its
prediction uses b = 2, the paper's Table IV accounting.

    PYTHONPATH=src python -m repro_torch.paper.fig4_validation
"""
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import commodel as cm
from repro_torch.core import parallel_exec as px
from repro_torch.core.comm import counts_by_collective, summarize
from repro_torch.launch.specs import param_sds

MODELS = ["llama32-3b", "llama31-8b", "llama2-13b"]
S, B, T = 128, 1, 4


def measure(arch: str) -> dict:
    """One full-size TP prefill of ``arch`` on meta tensors: its logged
    all-reduces and all-gathers against ``tp_comm_ops``."""
    cfg = get_config(arch)
    params, _ = param_sds(cfg)
    model = px.TPModel(cfg, T, plain=True)
    tokens = torch.zeros((B, S), dtype=torch.int32, device="meta")
    with torch.no_grad():
        model.tp_prefill(px.shard_params(cfg, params, T), tokens)
    meas = summarize(model.group.log)
    counts = counts_by_collective(meas)
    pred = cm.tp_comm_ops(cfg, S, 1, T, gather_mode="allgather", batch=B)
    ar = [o for o in meas if o.collective == "allreduce"]
    return {
        "arch": arch,
        "measured_ar": counts.get("allreduce", 0),
        "predicted_ar": sum(o.count for o in pred
                            if o.collective == "allreduce"),
        "measured_ar_bytes": sum(o.total_msg_bytes for o in ar),
        # bf16 on the wire (b = 2): the paper's Table IV accounting
        "predicted_ar_bytes": sum(o.count * o.elements * 2 for o in pred
                                  if o.collective == "allreduce"),
        "measured_ag": counts.get("allgather", 0),
    }


def rows():
    out = []
    for arch in MODELS:
        t0 = time.perf_counter()
        rec = measure(arch)
        us = (time.perf_counter() - t0) * 1e6
        match = (rec["measured_ar"] == rec["predicted_ar"]
                 and rec["measured_ar_bytes"] == rec["predicted_ar_bytes"])
        out.append((f"fig4/{rec['arch']}/tp4_fullsize", us,
                    f"measured_ar={rec['measured_ar']};"
                    f"predicted_ar={rec['predicted_ar']};"
                    f"ar_bytes={rec['measured_ar_bytes']};"
                    f"match={'EXACT' if match else 'MISMATCH'}"))
    return out


def main():
    print("Fig 4 — full-size measured (comm log) vs predicted (Eq.1) TP "
          "collectives")
    for r in rows():
        print(f"  {r[0]:34s} {r[2]}")


if __name__ == "__main__":
    main()
