"""The paper, end-to-end: predict communication for a deployment, compare
parallelism layouts, and get a recommendation — Sections III + V-C as an API.

    PYTHONPATH=src python -m repro_torch.examples.comm_study --arch llama31-8b --world 8

``--measure`` additionally runs the explicit PipelineEngine (reduced config,
p virtual stages on one device) through prefill + decode and prints the
logged boundary transfers next to the Eq. 2 / Table V predictions — the
measured counterpart of the analytical decode rows.

Counterpart of ``examples/comm_study.py`` with the same flags plus
``--device`` (default the card; it raises when there is none, as every
entry point of the port does).  The analytic part prints the JAX
example's lines.  On the card ``--measure`` launches B1,
``add_rms_norm`` and B2 on the prefill and B3 on each decode step,
through ``PipelineEngine(cfg, t=1, p=2)``; the stages need no host
devices, and the wire's bytes per element are the run's dtype's (4 on
the reduced f32 config, 2 in bf16).
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import commodel as cm
from repro_torch.core import parallel_exec as px
from repro_torch.core.planner import plan
from repro_torch.core.slo import predict_slo
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import get_model, resolve_device

def run(cfg, params, device, p: int = 2, s_p: int = 8,
        n_gen: int = 5) -> dict:
    """Measured vs predicted PP transfers of a prefill of ``s_p`` tokens
    and ``n_gen`` greedy tokens through ``PipelineEngine(cfg, t=1, p)``:
    per phase, the measured (count, bytes) and the send row of
    ``pp_comm_ops`` at s_d = n_gen + 1, b the dtype's bytes."""
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        2, cfg.vocab_size, (1, s_p)), dtype=torch.int32, device=device)
    eng = px.PipelineEngine(cfg, t=1, p=p, device=device)
    staged = eng.prepare(params)
    with torch.inference_mode():
        logits, caches = eng.prefill_with_cache(staged, toks, s_p + n_gen)
        tok0 = torch.argmax(logits, -1).to(torch.int32)
        eng.generate(staged, caches, tok0, s_p, n_gen)

    b = torch_dtype(cfg.dtype).itemsize
    ops = cm.pp_comm_ops(cfg, s_p, n_gen + 1, p, b=b, batch=1)
    rows = {}
    for phase in ("prefill", "decode"):
        got = eng.transfer_summary(phase=phase)
        want = [o for o in ops
                if o.collective == "send" and o.phase == phase][0]
        rows[phase] = {"measured": (got["count"], got["bytes"]),
                       "predicted": (want.count, want.total_msg_bytes)}
    return {"p": p, "s_p": s_p, "n_gen": n_gen, "b": b, "rows": rows}


def check(out: dict) -> None:
    """Every phase's measured transfers equal the Eq. 2 prediction."""
    for phase, r in out["rows"].items():
        if r["measured"] != r["predicted"]:
            raise AssertionError(f"{phase}: measured {r['measured']} != "
                                 f"predicted {r['predicted']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama31-8b")
    ap.add_argument("--world", type=int, default=8)
    ap.add_argument("--prefill", type=int, default=128)
    ap.add_argument("--decode", type=int, default=512)
    ap.add_argument("--measure", action="store_true",
                    help="run the reduced explicit PP engine and compare "
                         "logged decode transfers to Eq. 2")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    print(f"=== communication breakdown, {cfg.name}, "
          f"S_p={args.prefill} S_d={args.decode}")
    for name, t, p in [("TP", args.world, 1), ("PP", 1, args.world),
                       ("hybrid", 2, args.world // 2)]:
        ops = cm.comm_ops_for(cfg, args.prefill, args.decode, t, p)
        vol = cm.total_volume(ops)
        print(f"\n{name} (t={t}, p={p}): wire volume {vol/2**20:.1f} MiB")
        for o in ops:
            print(f"  {o.phase:8s} {o.collective:10s} count={o.count:7d} "
                  f"shape={list(o.shape)}")

    print("\n=== SLO predictions (H100-node profile)")
    for name, t, p in [("TP", args.world, 1), ("PP", 1, args.world),
                       ("hybrid", 2, args.world // 2)]:
        r = predict_slo(cfg, args.prefill, args.decode, t=t, p=p)
        print(f"  {name:7s} {r.row()}")

    print("\n=== planner recommendation (objective=e2e)")
    for c in plan(cfg, args.world, args.prefill, args.decode)[:3]:
        print(f"  {c.name:14s} {c.slo.row()}")

    if args.measure:
        small = get_config(args.arch).reduced(num_layers=4)
        params = get_model(small).init(seed=0, device=device)
        out = run(small, params, device)
        print(f"\n=== measured PP decode, {small.name} (t=1, p={out['p']}, "
              f"S_p={out['s_p']}, {out['n_gen']} generated tokens → "
              f"s_d={out['n_gen'] + 1})")
        for phase, r in out["rows"].items():
            (gc, gb), (wc, wb) = r["measured"], r["predicted"]
            tag = "OK" if (gc, gb) == (wc, wb) else "MISMATCH"
            print(f"  {phase:8s} measured count={gc:3d} bytes={gb:7d} | "
                  f"predicted count={wc:3d} bytes={wb:7d}  [{tag}]")
        check(out)
        return out
    return None


if __name__ == "__main__":
    main()
