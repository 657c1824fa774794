"""Aggregator of the paper's tables and figures on the port: one module per
table or figure, plus the dry-run readers.  Prints
``name,us_per_call,derived`` CSV and exits non-zero when a module fails.
Counterpart of ``benchmarks/run.py``.

    PYTHONPATH=src python -m repro_torch.paper.run
"""
from __future__ import annotations

import sys
import traceback

# The ported modules.  The JAX list's measuring scripts (decode_bench,
# serving_bench, kernel_bench, check_baselines) are the port's benchmark
# series, which writes its own BENCH files; chip_smoke.py phase 2 stands
# in for kernel_bench meanwhile.
MODULES = [
    "repro_torch.paper.table3_tp",
    "repro_torch.paper.table4_models",
    "repro_torch.paper.table5_pp",
    "repro_torch.paper.table6_hybrid",
    "repro_torch.paper.fig6_volume",
    "repro_torch.paper.fig7_scaling",
    "repro_torch.paper.fig8_9_10_slo",
    "repro_torch.paper.fig4_validation",
    "repro_torch.paper.planner_bench",
    "repro_torch.paper.roofline_table",
    "repro_torch.paper.perf_variants",
]


def main() -> None:
    import importlib
    print("name,us_per_call,derived")
    failures = []
    for modname in MODULES:
        try:
            mod = importlib.import_module(modname)
            for name, us, derived in mod.rows():
                print(f"{name},{us:.2f},{derived}")
        except Exception:
            failures.append(modname)
            traceback.print_exc(file=sys.stderr)
    if failures:
        print(f"# FAILED modules: {failures}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
