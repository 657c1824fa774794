"""Roofline table from the port's dry-run campaign
(results/dryrun_torch/*.json, ``repro_torch.launch.dryrun``).

One row per (arch × shape × mesh): the three roofline terms, the dominant
bottleneck, and the MODEL_FLOPS/walked-FLOPs useful ratio.  Counterpart of
``benchmarks/roofline_table.py``, with its record filter: a record that is
not ``ok`` (skipped, ``not_ported``, an error) is left out.

    PYTHONPATH=src python -m repro_torch.paper.roofline_table
"""
import glob
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR as RESULTS


def records(variant_filter=None):
    recs = []
    for f in sorted(glob.glob(os.path.join(RESULTS, "*.json"))):
        r = json.load(open(f))
        if r.get("status") != "ok":
            continue
        if variant_filter is not None and r.get("variant",
                                                "baseline") != variant_filter:
            continue
        recs.append(r)
    return recs


def rows():
    out = []
    for r in records("baseline"):
        rf = r["roofline"]
        step_ms = max(rf["compute_s"], rf["memory_s"],
                      rf["collective_s"]) * 1e3
        out.append((f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}",
                    step_ms * 1e3,
                    f"compute_ms={rf['compute_s']*1e3:.2f};"
                    f"memory_ms={rf['memory_s']*1e3:.2f};"
                    f"collective_ms={rf['collective_s']*1e3:.2f};"
                    f"dominant={rf['dominant']};"
                    f"useful={rf['useful_ratio']:.3f}"))
    return out


def main():
    print("Roofline terms per (arch × shape × mesh) — from the port's dry runs")
    recs = records("baseline")
    if not recs:
        print("  (no dry-run records yet: run python -m repro_torch.launch.dryrun --all)")
        return
    hdr = (f"  {'arch':18s} {'shape':12s} {'mesh':12s} {'compute':>10s} "
           f"{'memory':>10s} {'collective':>11s}  dominant   useful  GB/dev")
    print(hdr)
    for r in recs:
        rf = r["roofline"]
        print(f"  {r['arch']:18s} {r['shape']:12s} {r['mesh']:12s} "
              f"{rf['compute_s']*1e3:9.2f}ms {rf['memory_s']*1e3:9.2f}ms "
              f"{rf['collective_s']*1e3:10.2f}ms  {rf['dominant']:10s} "
              f"{rf['useful_ratio']:6.3f} "
              f"{r.get('bytes_per_device', 0)/2**30:7.2f}")


if __name__ == "__main__":
    main()
