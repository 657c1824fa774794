"""Paper Table VI: hybrid TP=2 × PP=2 breakdown, Llama-3.1-8B.

Counterpart of ``benchmarks/table6_hybrid.py`` on the port's analytic
modules; its rows equal the JAX script's.

    PYTHONPATH=src python -m repro_torch.paper.table6_hybrid
"""
from repro_torch.paper.common import timed
from repro_torch.configs import get_config
from repro_torch.core import commodel as cm


def rows():
    cfg = get_config("llama31-8b")
    ops, us = timed(lambda: cm.hybrid_comm_ops(cfg, 128, 128, 2, 2))
    return [(f"table6/tp2pp2/{o.phase}/{o.collective}", us,
             f"count={o.count};shape={list(o.shape)}") for o in ops]


def main():
    print("Table VI — hybrid TP=2 PP=2 breakdown (Llama-3.1-8B, 128/128)")
    for r in rows():
        print(f"  {r[0]:42s} {r[2]}")


if __name__ == "__main__":
    main()
