"""Paper Table IV: Allreduce message size & count across model scales.

Counterpart of ``benchmarks/table4_models.py`` on the port's analytic
modules; its rows equal the JAX script's.

    PYTHONPATH=src python -m repro_torch.paper.table4_models
"""
from repro_torch.paper.common import timed
from repro_torch.configs import get_config
from repro_torch.core import commodel as cm

MODELS = ["llama32-3b", "llama31-8b", "llama2-13b"]


def rows():
    out = []
    for arch in MODELS:
        cfg = get_config(arch)
        ops, us = timed(lambda c=cfg: cm.tp_comm_ops(c, 128, 128, 4))
        ar = [o for o in ops if o.collective == "allreduce"]
        out.append((f"table4/{arch}/prefill_allreduce", us,
                    f"msg_bytes={ar[0].msg_bytes};count={ar[0].count}"))
        out.append((f"table4/{arch}/decode_allreduce", us,
                    f"msg_bytes={ar[1].msg_bytes};count={ar[1].count}"))
    return out


def main():
    print("Table IV — Allreduce size/count across models (TP=4, 128/128)")
    for r in rows():
        print(f"  {r[0]:45s} {r[2]}")


if __name__ == "__main__":
    main()
