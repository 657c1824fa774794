"""Paper Table III: TP message size & frequency, Llama-3.1-8B, S_p=S_d=128.

Counterpart of ``benchmarks/table3_tp.py`` on the port's analytic
modules; its rows equal the JAX script's.

    PYTHONPATH=src python -m repro_torch.paper.table3_tp
"""
from repro_torch.paper.common import timed
from repro_torch.configs import get_config
from repro_torch.core import commodel as cm


def rows():
    cfg = get_config("llama31-8b")
    out = []
    for t in (2, 4):
        ops, us = timed(lambda t=t: cm.tp_comm_ops(cfg, 128, 128, t))
        for o in ops:
            out.append((f"table3/tp{t}/{o.phase}/{o.collective}", us,
                        f"count={o.count};shape={list(o.shape)};"
                        f"msg_bytes={o.msg_bytes}"))
    return out


def main():
    cfg = get_config("llama31-8b")
    print("Table III — TP message size and frequency (Llama-3.1-8B, 128/128)")
    for t in (2, 4):
        print(f"  TP={t}")
        for o in cm.tp_comm_ops(cfg, 128, 128, t):
            print(f"    {o.phase:8s} {o.collective:10s} count={o.count:6d} "
                  f"shape={list(o.shape)} msg={o.msg_bytes}B")


if __name__ == "__main__":
    main()
