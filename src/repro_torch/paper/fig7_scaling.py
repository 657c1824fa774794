"""Paper Fig 7: communication volume vs decode sequence length.

Counterpart of ``benchmarks/fig7_scaling.py`` on the port's analytic
modules; its rows equal the JAX script's.

    PYTHONPATH=src python -m repro_torch.paper.fig7_scaling
"""
from repro_torch.paper.common import timed
from repro_torch.configs import get_config
from repro_torch.core import commodel as cm

MODELS = ["llama32-3b", "llama31-8b", "llama2-13b"]
LAYOUTS = [("tp4", 4, 1), ("pp4", 1, 4), ("tp2pp2", 2, 2)]
SD = [128, 256, 512]


def rows():
    out = []
    for arch in MODELS:
        cfg = get_config(arch)
        for name, t, p in LAYOUTS:
            vols = {}
            for sd in SD:
                vols[sd], us = timed(lambda c=cfg, t=t, p=p, sd=sd:
                                     cm.total_volume(
                                         cm.hybrid_comm_ops(c, 128, sd, t, p)))
            g1 = vols[256] / vols[128]
            g2 = vols[512] / vols[256]
            out.append((f"fig7/{arch}/{name}", us,
                        f"v128={vols[128]:.0f};v256={vols[256]:.0f};"
                        f"v512={vols[512]:.0f};growth={g1:.2f}x/{g2:.2f}x"))
    return out


def main():
    print("Fig 7 — decode-length scaling (S_p=128, bf16)")
    for r in rows():
        print(f"  {r[0]:34s} {r[2]}")
    cfg = get_config("llama31-8b")
    v = {sd: cm.v_tp(cfg, 128, sd, 4) for sd in SD}
    print(f"  growth factors (TP4, 8B): {v[256]/v[128]:.3f} (paper ~1.50), "
          f"{v[512]/v[256]:.3f} (paper ~1.67)")


if __name__ == "__main__":
    main()
