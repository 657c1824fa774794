"""Paper Fig 6: total communication volume per parallelism strategy.

Counterpart of ``benchmarks/fig6_volume.py`` on the port's analytic
modules; its rows equal the JAX script's.

    PYTHONPATH=src python -m repro_torch.paper.fig6_volume
"""
from repro_torch.paper.common import fmt_bytes, timed
from repro_torch.configs import get_config
from repro_torch.core import commodel as cm

MODELS = ["llama32-3b", "llama31-8b", "llama2-13b"]
LAYOUTS = [("tp4", 4, 1), ("pp4", 1, 4), ("tp2pp2", 2, 2)]


def rows():
    out = []
    for arch in MODELS:
        cfg = get_config(arch)
        for name, t, p in LAYOUTS:
            vol, us = timed(lambda c=cfg, t=t, p=p: cm.total_volume(
                cm.hybrid_comm_ops(c, 128, 128, t, p)))
            out.append((f"fig6/{arch}/{name}", us,
                        f"wire_bytes={vol:.0f};{fmt_bytes(vol)}"))
    return out


def main():
    print("Fig 6 — communication volume by strategy (128/128, bf16)")
    for r in rows():
        print(f"  {r[0]:34s} {r[2]}")
    # invariant highlighted in the paper
    for arch in MODELS:
        cfg = get_config(arch)
        v = {n: cm.total_volume(cm.hybrid_comm_ops(cfg, 128, 128, t, p))
             for n, t, p in LAYOUTS}
        assert v["pp4"] < v["tp2pp2"] < v["tp4"]
    print("  ordering PP < hybrid < TP holds for all models ✓")


if __name__ == "__main__":
    main()
