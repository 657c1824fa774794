"""Quantized-collective demo: the decode hot path on an int8 wire.

Runs the same greedy decode twice on the TP engine — once with full-width
all-reduces (the paper's §V-B hot path) and once with the quantized
two-step (DESIGN.md §12: per-chunk quantize → reduce-scatter int8 →
all-gather int8 → dequantize) — and prints what the swap costs and saves:

  * predicted decode wire bytes per step, both ways, from the commodel
    closed form (the int8 payload + f32 scale exchange lands ≈ 0.52× the
    bf16 all-reduce wire);
  * greedy token-match rate and max logit drift, measured teacher-forced
    against the full-width run;
  * decode tokens/sec, both ways.

The ``QUANT_TOLERANCE`` numerics contract is asserted at the end — the
demo fails loudly if the quantized path stops agreeing with bf16.

    PYTHONPATH=src python -m repro_torch.examples.quant_demo --tp 2 --tokens 16

Counterpart of ``examples/quant_demo.py`` with the same flags plus
``--device`` (default the card; it raises when there is none).  The t TP
ranks are ``TPModel``'s virtual ranks on one device, so no host devices
are needed; the weights are drawn from seed 0 by the port's
``Model.init``, the prompts from seed 1 by numpy (or given).  The wire's
bytes per element are the run's dtype's (4 on the reduced f32 config),
and both decodes' logged collectives are held to the closed form.  On
the card the quantized step launches B5 and B6 per rank and all-reduce,
and the dequantize (B9) inside ``dequantize_add_rms_norm``; both steps
launch B3.
"""
import argparse
import time

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch.configs import get_config
from repro_torch.core import comm
from repro_torch.core import commodel as cm
from repro_torch.core import parallel_exec as px
from repro_torch.kernels.quant_collective import QUANT_TOLERANCE
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import get_model, resolve_device

PREFILL = 8


def run(cfg, params, device, tp: int = 2, tokens: int = 16, batch: int = 4,
        quant: str = "int8", prompts=None) -> dict:
    """Greedy decode of ``tokens`` steps after an 8-token prefill of
    ``prompts`` ([batch, 8]; drawn from seed 1 when None) on
    ``TPModel(cfg, tp)``, unquantized and teacher-forced on the ``quant``
    wire: both runs' logits and tokens, their top-1 match and max logit
    drift, the predicted decode wire bytes a step both ways, the
    collectives each decode logged beside ``tokens`` steps of the closed
    form, and tokens/s both ways (a warm-up run, then a timed one)."""
    device = torch.device(device)
    ranks = px.shard_params(cfg, params, tp)
    if prompts is None:
        prompts = np.random.default_rng(1).integers(
            2, cfg.vocab_size, (batch, PREFILL))
    toks = torch.as_tensor(np.array(prompts), dtype=torch.int32,
                           device=device)
    model_b = px.TPModel(cfg, tp)
    model_q = px.TPModel(cfg, tp, quant=quant)
    with torch.inference_mode():
        logits, cache0 = model_b.tp_prefill(ranks, toks,
                                            cache_w=PREFILL + tokens)
    tok0 = torch.argmax(logits, -1).to(torch.int32)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    @torch.inference_mode()
    def decode(model, forced=None):
        cache, tok = tree_map(torch.clone, cache0), tok0
        logits_all, toks_all = [], []
        for i in range(tokens):
            lg, cache = model.tp_decode_step(ranks, cache, tok, PREFILL + i)
            choice = torch.argmax(lg, -1).to(torch.int32)
            logits_all.append(lg)
            toks_all.append(choice)
            tok = choice if forced is None else forced[i]
        sync()
        return torch.stack(logits_all), torch.stack(toks_all)

    def tokens_per_s(model):
        decode(model)                                 # warm-up
        t0 = time.perf_counter()
        decode(model)
        return tokens * batch / (time.perf_counter() - t0)

    # predicted per-step decode wire bytes (commodel closed form) at the
    # run's bytes per element
    b = torch_dtype(cfg.dtype).itemsize

    def decode_ops(q):
        return [o for o in cm.comm_ops_for(cfg, 1, 2, tp, 1, b=b,
                                           batch=batch,
                                           gather_mode="allgather", quant=q)
                if o.phase == "decode"]

    ops_b, ops_q = decode_ops(None), decode_ops(quant)
    ref = decode(model_b)
    got = decode(model_q, forced=ref[1])
    # each decode's logged collectives, before the timed runs add to them
    logged = {"b": comm.fold(model_b.group.summary("decode")),
              "q": comm.fold(model_q.group.summary("decode"))}
    match = float((got[1] == ref[1]).float().mean())
    drift = float((got[0].float() - ref[0].float()).abs().max())
    return {"tp": tp, "tokens": tokens, "batch": batch, "quant": quant,
            "b": b, "ref": ref, "got": got,
            "wire_b": sum(o.wire_bytes for o in ops_b),
            "wire_q": sum(o.wire_bytes for o in ops_q),
            "logged": logged,
            "predicted": {"b": comm.fold(ops_b), "q": comm.fold(ops_q)},
            "ratio": cm.quant_ar_wire_ratio(cfg.d_model, tp, quant=quant,
                                            b=b),
            "match": match, "drift": drift,
            "tps_b": tokens_per_s(model_b), "tps_q": tokens_per_s(model_q)}


def check(out: dict, floor: float, ceiling: float) -> None:
    """Teacher-forced top-1 match at least ``floor`` and max logit drift
    at most ``ceiling``."""
    if not out["match"] >= floor:
        raise AssertionError(f"token match {out['match']:.4f} below "
                             f"contract {floor}")
    if not out["drift"] <= ceiling:
        raise AssertionError(f"logit drift {out['drift']:.4f} above "
                             f"contract {ceiling}")


def check_wire(out: dict, ceiling: float = None) -> None:
    """Each decode's logged collectives ``tokens`` times the closed form's
    step, and, given a ``ceiling``, the predicted quantized decode wire
    under ``ceiling`` times the full-width one."""
    for k in ("b", "q"):
        want = {key: n * out["tokens"]
                for key, n in out["predicted"][k].items()}
        if out["logged"][k] != want:
            raise AssertionError(f"decode ({k}) logged {out['logged'][k]}, "
                                 f"comm_ops_for x {out['tokens']}: {want}")
    if ceiling is not None and not out["wire_q"] < ceiling * out["wire_b"]:
        raise AssertionError(f"quantized wire {out['wire_q']:.0f} not < "
                             f"{ceiling}x full-width {out['wire_b']:.0f}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32-3b")
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--quant", default="int8", choices=["int8", "fp8"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced(num_layers=2)
    params = get_model(cfg).init(seed=0, device=device)
    out = run(cfg, params, device, tp=args.tp, tokens=args.tokens,
              batch=args.batch, quant=args.quant)
    wire_b, wire_q = out["wire_b"], out["wire_q"]
    print(f"{cfg.name} reduced, TP={args.tp}, B={args.batch}, "
          f"{args.tokens} greedy tokens, quant={args.quant}")
    print(f"  predicted decode wire/step: {wire_b / 1024:.1f} KiB bf16-path "
          f"-> {wire_q / 1024:.1f} KiB quantized "
          f"({100 * (1 - wire_q / wire_b):.1f}% saved; per-layer AR ratio "
          f"{out['ratio']:.4f})")
    print(f"  token_match_rate {out['match']:.4f}   max_logit_drift "
          f"{out['drift']:.4f}")
    print(f"  tokens/sec: {out['tps_b']:.1f} full-width -> "
          f"{out['tps_q']:.1f} quantized")

    tol = QUANT_TOLERANCE[args.quant]
    check(out, tol["token_match_floor"], tol["logit_drift_ceiling"])
    check_wire(out, 0.6)
    print(f"  OK: within QUANT_TOLERANCE[{args.quant!r}] "
          f"(floor {tol['token_match_floor']}, "
          f"ceiling {tol['logit_drift_ceiling']}) and wire < 0.6x bf16-path")
    return out


if __name__ == "__main__":
    main()
