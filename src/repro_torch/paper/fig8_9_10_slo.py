"""Paper Figs 8–10: SLO predictions per parallelism layout (α–β model).

Counterpart of ``benchmarks/fig8_9_10_slo.py`` on the port's analytic
modules; its rows equal the JAX script's.

    PYTHONPATH=src python -m repro_torch.paper.fig8_9_10_slo
"""
from repro_torch.paper.common import timed
from repro_torch.configs import get_config
from repro_torch.core.slo import predict_slo


def rows():
    out = []
    l3 = get_config("llama32-3b")
    for t in (2, 4, 8):                                   # Fig 8
        r, us = timed(lambda t=t: predict_slo(l3, 128, 128, t=t))
        out.append((f"fig8/llama32-3b/tp{t}", us,
                    f"ttft_ms={r.ttft*1e3:.1f};tpot_ms={r.tpot*1e3:.2f};"
                    f"e2e_s={r.e2e:.2f}"))
    for p in (2, 4, 8):                                   # Fig 9
        r, us = timed(lambda p=p: predict_slo(l3, 128, 128, t=1, p=p))
        out.append((f"fig9/llama32-3b/pp{p}", us,
                    f"ttft_ms={r.ttft*1e3:.1f};tpot_ms={r.tpot*1e3:.2f};"
                    f"e2e_s={r.e2e:.2f}"))
    l13 = get_config("llama2-13b")
    for t, p in ((8, 1), (1, 8), (2, 4), (4, 2)):         # Fig 10
        r, us = timed(lambda t=t, p=p: predict_slo(l13, 128, 128, t=t, p=p))
        out.append((f"fig10/llama2-13b/tp{t}pp{p}", us,
                    f"ttft_ms={r.ttft*1e3:.1f};tpot_ms={r.tpot*1e3:.2f};"
                    f"e2e_s={r.e2e:.2f}"))
    return out


def main():
    print("Figs 8-10 — SLO predictions (H100-node profile, fitted constants)")
    print("  paper anchors: Fig8 TTFT 150/90/30ms TPOT 1.17/0.86/11.56ms;")
    print("                 Fig9 TTFT 430/1110/2520ms; Fig10 TP8 best (70ms)")
    for r in rows():
        print(f"  {r[0]:32s} {r[2]}")


if __name__ == "__main__":
    main()
