"""Paper Table V: PP send/recv counts and shapes, Llama-3.1-8B.

Counterpart of ``benchmarks/table5_pp.py`` on the port's analytic
modules; its rows equal the JAX script's.

    PYTHONPATH=src python -m repro_torch.paper.table5_pp
"""
from repro_torch.paper.common import timed
from repro_torch.configs import get_config
from repro_torch.core import commodel as cm


def rows():
    cfg = get_config("llama31-8b")
    out = []
    for p in (2, 4):
        ops, us = timed(lambda p=p: cm.pp_comm_ops(cfg, 128, 128, p))
        for o in ops:
            out.append((f"table5/pp{p}/{o.phase}/{o.collective}", us,
                        f"count={o.count};shape={list(o.shape)}"))
    return out


def main():
    print("Table V — PP point-to-point breakdown (Llama-3.1-8B, 128/128)")
    for r in rows():
        print(f"  {r[0]:40s} {r[2]}")


if __name__ == "__main__":
    main()
