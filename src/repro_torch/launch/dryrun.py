"""Multi-pod dry run of the port: one sharded step of every (arch x shape x
mesh) combination, on meta tensors over a fake process group.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
step for 256 or 512 host devices.  For each combination this script:
  1. builds the production mesh (16x16 single pod, 2x16x16 multi-pod) as a
     ``DeviceMesh`` over the "fake" process group of 256 or 512 ranks
     (``runtime.sharding.fake_device_mesh``; this process is rank 0),
  2. places the step's inputs as meta DTensors by the sharding rules
     (``launch.specs``: parameters, batch, cache, optimizer state) and
     runs the step (train_step / prefill / serve_step) sharded
     (``runtime.meshctx``): nothing is allocated and nothing is sent,
  3. reads rank 0's local program twice: its collectives
     (``core.step_comm``, the counterpart of ``hlo_comm``) and its FLOPs,
     HBM bytes and peak live bytes (``core.op_cost``'s walk per chip),
  4. holds the collectives to their closed form
     (``step_comm.closed_form``) and writes the record, with the roofline
     on ``H100_NODE``, to results/dryrun_torch/<arch>__<shape>__<mesh>.json.

The records have JAX's keys (``memory_analysis``, ``bytes_per_device``,
``cost_analysis``, ``collectives``, ``roofline``) plus ``closed_form`` and
``collectives_match``.  ``memory_analysis`` is the eager step's:
arguments and outputs are the rank's local bytes, ``temp_size_in_bytes``
the walk's peak of live intermediates.  Every family runs sharded, and
so do the ``moe_local*`` variants (the local MoE dispatch, with and
without ``moe_fsdp``); a variant whose feature the sharded step raises
``NotImplementedError`` for (the fused loss, paged serving, the GSPMD
dispatch under ``moe_fsdp``) is recorded as ``not_ported`` with the
step's reason; any other fault is an error.

Usage (the CPU is enough):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape prefill_32k [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # a process each
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

ASSIGNED_ARCHS = [
    "granite-8b", "rwkv6-7b", "mixtral-8x22b", "internlm2-1.8b",
    "phi3-mini-3.8b", "hubert-xlarge", "paligemma-3b", "gemma-7b",
    "deepseek-moe-16b", "hymba-1.5b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _record_path(arch: str, shape: str, mesh_name: str) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    return os.path.join(RESULTS_DIR, f"{arch}__{shape}__{mesh_name}.json")


def _nbytes(tree) -> int:
    from repro_torch.checkpoint.store import flatten
    import torch
    total = 0
    for t in (flatten(tree).values() if isinstance(tree, dict) else tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if hasattr(t, "to_local") else t
            total += local.numel() * local.element_size()
    return total


def _step(cfg, shape, dmesh, params):
    """(the step function, its arguments, their local bytes, the bytes
    it updates in place) of one shape's step on meta DTensors."""
    from repro_torch.launch import specs as sp
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime.engine import make_serve_step

    model = get_model(cfg, plain=True)
    if shape.mode == "train":
        from repro_torch.optim.adamw import AdamW
        from repro_torch.runtime.train import make_train_step
        optimizer = AdamW()
        opt = optimizer.init(params)
        batch, _ = sp.batch_specs(cfg, shape, dmesh)
        fn = make_train_step(model, optimizer, device="meta")
        args = (params, opt, batch)
        return fn, args, _nbytes(params) + _nbytes(opt["m"]) * 2 \
            + _nbytes(batch), _nbytes(params) + 2 * _nbytes(opt["m"])
    if shape.mode == "prefill":
        batch, _ = sp.batch_specs(cfg, shape, dmesh)

        def prefill_fn(params, batch):
            if cfg.family == "encoder":
                logits, _ = model.forward(params, features=batch["features"])
                return logits
            logits, cache, _ = model.prefill(params, batch["tokens"],
                                             max_len=shape.seq_len,
                                             prefix_emb=batch.get(
                                                 "prefix_emb"))
            return logits, cache

        return prefill_fn, (params, batch), \
            _nbytes(params) + _nbytes(batch), 0
    (tok, pos, cache), _ = sp.decode_specs(cfg, shape, dmesh)
    step = make_serve_step(model)
    return step, (params, cache, tok, shape.seq_len - 1), \
        _nbytes(params) + _nbytes(cache) + _nbytes([tok]), _nbytes(cache)


def run_one(arch: str, shape_name: str, multi_pod: bool,
            variant: str = "baseline") -> dict:
    import torch
    from torch.utils._pytree import tree_flatten

    from repro_torch.config.base import H100_NODE, INPUT_SHAPES
    from repro_torch.configs import get_config
    from repro_torch.core import op_cost, roofline, step_comm
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.runtime import meshctx
    from repro_torch.runtime import sharding as sh

    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cfg = get_config(arch)
    if variant != "baseline":
        cfg = apply_variant(cfg, variant)
        mesh_name += f"__{variant}"
    shape = INPUT_SHAPES[shape_name]
    t0 = time.time()
    reason = sp.skip_reason(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "variant": variant, "status": "skip", "skip_reason": reason}
    if reason is not None:
        return rec
    if variant.startswith("mesh"):
        d, m = variant[4:].split("-")[0].split("x")
        mesh = make_mesh((int(d), int(m)), ("data", "model"))
    else:
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = 1
    for n in mesh.shape.values():
        n_chips *= n
    dmesh = sh.fake_device_mesh(mesh)
    meshctx.set_device_mesh(dmesh)
    try:
        params, _ = sp.param_sds(cfg, dmesh)
        fn, args, arg_bytes, alias_bytes = _step(cfg, shape, dmesh, params)
        grad = torch.enable_grad() if shape.mode == "train" \
            else torch.no_grad()
        t1 = time.time()
        with grad:
            out, log = step_comm.record(fn, *args)
        out_bytes = _nbytes(tree_flatten(out)[0])
        del out
        # the walk runs the step again on fresh inputs (the optimizer
        # state of the first run is spent)
        t2 = time.time()
        fn, args, _, _ = _step(cfg, shape, dmesh, params)
        with grad:
            cost = op_cost.count(fn, *args,
                                 kv_rows=shape.seq_len
                                 if shape.mode == "decode" else None)
        t3 = time.time()
    except NotImplementedError as exc:   # a feature the step does not shard
        if variant == "baseline":
            raise
        rec.update(status="not_ported", skip_reason=str(exc)[:400])
        return rec
    finally:
        meshctx.set_device_mesh(None)
    summary = step_comm.summarize(log)
    S = shape.seq_len
    form = step_comm.closed_form(
        cfg, shape.mode, mesh.shape, shape.global_batch,
        1 if shape.mode == "decode" else S, cache_width=S,
        param_bytes=step_comm.local_param_bytes(params)
        if shape.mode == "train" else None, remat=cfg.remat)
    rep = roofline.analyze(cfg, shape, mesh_name, n_chips, cost.flops,
                           cost.min_bytes, summary, hw=H100_NODE)
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": int(cost.peak_bytes),
           "alias_size_in_bytes": alias_bytes}
    rec.update({
        "status": "ok",
        "n_chips": n_chips,
        "seconds_to_compile": round(time.time() - t0, 1),
        # the record of the collectives and the op walk, apart (CPU)
        "seconds_record": round(t2 - t1, 1),
        "seconds_walk": round(t3 - t2, 1),
        "memory_analysis": mem,
        "bytes_per_device": arg_bytes + int(cost.peak_bytes),
        "cost_analysis": {"flops": cost.flops, "bytes accessed": cost.bytes,
                          "min_bytes": cost.min_bytes},
        "collectives": summary,
        "closed_form": form,
        "collectives_match": step_comm.same(summary, form),
        "trivial_collectives": len(step_comm.trivial(log)),
        "roofline": {
            "flops_per_chip": rep.flops_per_chip,
            "hbm_bytes_per_chip": rep.hbm_bytes_per_chip,
            "coll_bytes_per_chip": rep.coll_bytes_per_chip,
            "compute_s": rep.compute_s,
            "memory_s": rep.memory_s,
            "collective_s": rep.collective_s,
            "dominant": rep.dominant,
            "model_flops_total": rep.model_flops_total,
            "useful_ratio": rep.useful_ratio,
        },
        "roofline_row": rep.row(),
    })
    return rec


def apply_variant(cfg, variant: str):
    """Named beyond-baseline configuration variants (JAX's, as there)."""
    import dataclasses as dc
    if variant.startswith("mesh"):
        rest = variant.split("-", 1)
        return apply_variant(cfg, rest[1]) if len(rest) > 1 else cfg
    if variant == "remat":
        return dc.replace(cfg, remat="dots")
    if variant == "remat_full":
        return dc.replace(cfg, remat="full")
    if variant == "chunked_attn":
        return dc.replace(cfg, attention_impl="chunked")
    if variant.startswith("chunked_attn_c"):
        return dc.replace(cfg, attention_impl="chunked",
                          attention_chunk=int(variant.rsplit("c", 1)[1]))
    if variant == "chunked_attn_remat":
        return dc.replace(cfg, attention_impl="chunked", remat="dots")
    if variant == "moe_local":
        return dc.replace(cfg, moe_dispatch="local")
    if variant == "moe_local_fsdp":
        return dc.replace(cfg, moe_dispatch="local", moe_fsdp=True)
    if variant == "moe_local_chunked":
        return dc.replace(cfg, moe_dispatch="local", attention_impl="chunked")
    if variant == "moe_local_fsdp_chunked":
        return dc.replace(cfg, moe_dispatch="local", moe_fsdp=True,
                          attention_impl="chunked")
    if variant == "rwkv_chunked":
        return dc.replace(cfg, ssm=dc.replace(cfg.ssm, scan_impl="chunked"))
    if variant.startswith("rwkv_chunked_c"):
        return dc.replace(cfg, ssm=dc.replace(
            cfg.ssm, scan_impl="chunked",
            scan_chunk=int(variant.rsplit("c", 1)[1])))
    if variant == "ssm_attn_chunked":
        return dc.replace(cfg, attention_impl="chunked",
                          ssm=dc.replace(cfg.ssm, scan_impl="chunked"))
    if variant == "rwkv_chunked_remat":
        return dc.replace(cfg, remat="dots",
                          ssm=dc.replace(cfg.ssm, scan_impl="chunked"))
    raise KeyError(variant)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch, shape, mesh) in subprocesses")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s, mp) for a in ASSIGNED_ARCHS for s in SHAPES
                  for mp in (False, True)]
        failures = []
        t0 = time.time()
        for a, s, mp in combos:
            mesh_name = "pod2x16x16" if mp else "pod16x16"
            path = _record_path(a, s, mesh_name)
            if os.path.exists(path) and not args.force:
                print(f"[cached] {a} {s} {mesh_name}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s]
            if mp:
                cmd.append("--multi-pod")
            print(f"[run] {a} {s} {mesh_name} ...", flush=True)
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                failures.append((a, s, mesh_name, r.stderr[-2000:]))
                print(f"[FAIL] {a} {s} {mesh_name}\n{r.stderr[-2000:]}")
        print(f"done in {time.time() - t0:.1f} s; {len(failures)} failures")
        sys.exit(1 if failures else 0)

    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    if args.variant != "baseline":
        mesh_name += f"__{args.variant}"
    path = _record_path(args.arch, args.shape, mesh_name)
    try:
        rec = run_one(args.arch, args.shape, args.multi_pod, args.variant)
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape, "mesh": mesh_name,
               "status": "error", "error": traceback.format_exc()[-4000:]}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(json.dumps({k: rec[k] for k in ("arch", "shape", "status")}))
        raise
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if rec["status"] == "ok":
        print(json.dumps({k: rec[k] for k in
                          ("arch", "shape", "mesh", "status", "n_chips",
                           "bytes_per_device", "seconds_to_compile",
                           "seconds_record", "seconds_walk",
                           "collectives_match")}))
        print("memory_analysis:", rec["memory_analysis"])
        print("cost_analysis flops:", rec["cost_analysis"].get("flops"))
        print("collectives:", json.dumps(rec["collectives"]))
        print("roofline:", rec["roofline_row"])
        if not rec["collectives_match"]:
            print("closed form:", json.dumps(rec["closed_form"]))
            sys.exit(1)
    else:
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
