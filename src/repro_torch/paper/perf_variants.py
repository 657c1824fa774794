"""§Perf hillclimb results: baseline vs optimized variants per selected pair
(reads the port's archived dry-run records, ``repro_torch.launch.dryrun
--variant``).  Degrades to a single informational row when the
``results/dryrun_torch`` archive is absent (fresh checkout).  Counterpart
of ``benchmarks/perf_variants.py``, with its pairs and its filter: a
record that is not ``ok`` is left out — the ``moe_local*`` variants
record ``not_ported`` while the local MoE dispatch does not run on a
``DeviceMesh``.

    PYTHONPATH=src python -m repro_torch.paper.perf_variants
"""
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR as RESULTS

PAIRS = [
    ("rwkv6-7b", "train_4k",
     ["baseline", "rwkv_chunked", "rwkv_chunked_remat", "remat",
      "rwkv_chunked_c32", "mesh64x4", "mesh64x4-rwkv_chunked_remat"]),
    ("mixtral-8x22b", "prefill_32k",
     ["baseline", "moe_local", "moe_local_fsdp", "moe_local_fsdp_chunked"]),
    ("granite-8b", "prefill_32k",
     ["baseline", "chunked_attn", "chunked_attn_c4096"]),
    ("hymba-1.5b", "prefill_32k",
     ["baseline", "rwkv_chunked", "ssm_attn_chunked"]),
    ("hymba-1.5b", "train_4k", ["baseline", "rwkv_chunked"]),
    ("rwkv6-7b", "prefill_32k", ["baseline", "rwkv_chunked"]),
    ("deepseek-moe-16b", "prefill_32k",
     ["baseline", "moe_local_fsdp_chunked"]),
]


def _load(arch, shape, variant):
    suffix = "" if variant == "baseline" else f"__{variant}"
    path = os.path.join(RESULTS, f"{arch}__{shape}__pod16x16{suffix}.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            r = json.load(f)
    except (OSError, ValueError):
        return None
    return r if r.get("status") == "ok" else None


def rows():
    if not os.path.isdir(RESULTS):
        return [("perf/variants", 0.0,
                 "no_dryrun_archive;run launch/dryrun.py to populate "
                 "results/dryrun_torch")]
    out = []
    for arch, shape, variants in PAIRS:
        base = _load(arch, shape, "baseline")
        for v in variants:
            r = _load(arch, shape, v)
            if r is None:
                continue
            rf = r["roofline"]
            dom_val = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
            speedup = ""
            if base and v != "baseline":
                b = base["roofline"]
                bdom = max(b["compute_s"], b["memory_s"], b["collective_s"])
                speedup = f";bound_speedup={bdom/dom_val:.2f}x"
            out.append((f"perf/{arch}/{shape}/{v}", dom_val * 1e6,
                        f"memory_s={rf['memory_s']:.2f};"
                        f"collective_s={rf['collective_s']:.2f};"
                        f"GB_dev={r['bytes_per_device']/2**30:.1f}{speedup}"))
    return out


def main():
    print("§Perf hillclimbs — roofline bound per variant")
    for r in rows():
        print(f"  {r[0]:56s} {r[2]}")


if __name__ == "__main__":
    main()
