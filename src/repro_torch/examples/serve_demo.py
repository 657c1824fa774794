"""Serving demo: continuous batching over a mixed-length request trace.

Drives the request-level serving layer the paper's SLO study implies
(runtime/scheduler.py over a DecodeBackend): Poisson arrivals, distinct
prompt/decode lengths per request, admission into freed KV-cache slots
mid-decode, EOS/length eviction — with measured per-request TTFT / TPOT /
E2E printed next to the analytical ``core.slo.predict_slo`` prediction for
the same layout.

    PYTHONPATH=src python -m repro_torch.examples.serve_demo --backend gspmd \\
        --requests 8 --slots 4 --rate 4
    PYTHONPATH=src python -m repro_torch.examples.serve_demo --backend pp --pp 2
    PYTHONPATH=src python -m repro_torch.examples.serve_demo --backend tp \\
        --tp 1 --cp 2
        (the explicit engines run t ranks, c CP workers and p stages as
         virtual ranks on one device; --cp > 1 sequence-shards each
         prefill over the CP workers, DESIGN.md §9)
    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        -m repro_torch.examples.serve_demo --backend tp --tp 4
        (under torchrun each of the t·c·p ranks is a process on its own
         card, over NCCL: --backend pp --pp 4, --backend pp --tp 2
         --pp 2, --backend tp --tp 1 --cp 4, --backend tp --tp 2 --cp 2
         or --backend pp --tp 1 --cp 2 --pp 2; every rank serves the
         trace on rank 0's clock, rank 0 prints the report, and the
         ranks' admissions and streams are checked equal)

Counterpart of ``examples/serve_demo.py`` with the same flags plus
``--device`` (default the card; it raises when there is none); the
weights are drawn from seed 0 by the port's ``Model.init``.  On the card
the contiguous gspmd backend launches B1, ``add_rms_norm``, B2 on each
prefill and B3 on each decode step.
"""
import argparse
import os

import numpy as np
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import comm
from repro_torch.core.slo import predict_slo
from repro_torch.models.transformer import get_model, resolve_device
from repro_torch.runtime.backends import make_backend
from repro_torch.runtime.request import make_poisson_trace, Request
from repro_torch.runtime.scheduler import Scheduler


def layout(backend: str, tp: int = None, cp: int = 1, pp: int = 2):
    """(t, c, p) of the flags: t defaults to 2 on the tp backend (without
    CP) and to 1 otherwise; p is 1 off the pp backend."""
    t = tp if tp is not None else \
        (2 if backend == "tp" and cp < 2 else 1)
    return t, cp, pp if backend == "pp" else 1


def run(cfg, params, device, backend: str = "gspmd", tp: int = None,
        cp: int = 1, pp: int = 2, requests: int = 8, slots: int = 4,
        rate: float = 4.0, prompt_lens=(8, 40), decode_lens=(4, 16),
        max_len: int = 96, place=None) -> dict:
    """Serve a Poisson trace through the Scheduler on the wall clock, after
    a warm-up run of one 2-token request per distinct prompt length.
    Returns the trace, the report, its summary, the backend's (t, c, p)
    and ``predict_slo`` at the trace's mean prompt and decode lengths.
    ``place`` (``core.comm.dist_groups``) runs this process's rank of a
    world of t·c·p."""
    t, c, p = layout(backend, tp, cp, pp)
    be = make_backend(backend, cfg, params, num_slots=slots,
                      max_len=max_len, t=t, c=c, p=p, device=device,
                      place=place)
    trace = make_poisson_trace(requests, rate, cfg.vocab_size,
                               prompt_lens=tuple(prompt_lens),
                               decode_lens=tuple(decode_lens),
                               seed=0, quantum=8)

    # warm the allocator and the libraries' first calls (one 2-token
    # request per distinct prompt length + the decode step) so the
    # measured TTFT/TPOT below is serving time — comparable to predict_slo
    wrng = np.random.default_rng(1)
    Scheduler(be).run(
        [Request(rid=10_000 + j, prompt=wrng.integers(2, cfg.vocab_size, s),
                 max_new_tokens=2)
         for j, s in enumerate(sorted({r.prompt_len for r in trace}))])

    report = Scheduler(be).run(trace)
    sp = sum(prompt_lens) // 2
    sd = sum(decode_lens) // 2
    return {"trace": trace, "report": report, "summary": report.summary(),
            "t": be.t, "c": be.c, "p": be.p, "s_p": sp, "s_d": sd,
            "predicted": predict_slo(cfg, sp, sd, t=be.t, p=be.p, c=be.c)}


def check(out: dict, place=None) -> None:
    """Every request of the trace finished by length with its whole
    decode budget (the scheduler itself asserts each step's collectives
    against commodel.comm_ops_for); on ranks (``place``), every rank
    admitted the same requests at the same times and made the same
    streams."""
    if place is not None:
        mine = [(m.rid, m.admitted, m.first_token, list(m.tokens))
                for m in out["report"].metrics]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        for r, theirs in enumerate(every):
            if theirs != every[0]:
                raise AssertionError(f"rank {r} served the trace otherwise "
                                     f"than rank 0: {theirs} != {every[0]}")
    by = {m.rid: m for m in out["report"].metrics}
    for r in out["trace"]:
        m = by.get(r.rid)
        if m is None or m.finish_reason != "length" or \
                m.num_generated != r.max_new_tokens:
            raise AssertionError(
                f"request {r.rid}: "
                + ("not served" if m is None else
                   f"{m.num_generated} of {r.max_new_tokens} tokens "
                   f"({m.finish_reason})"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32-3b")
    ap.add_argument("--backend", default="gspmd",
                    choices=["gspmd", "tp", "pp"])
    ap.add_argument("--tp", type=int, default=None,
                    help="TP degree (default: 2 for --backend tp, else 1)")
    ap.add_argument("--cp", type=int, default=1,
                    help="context-parallel degree (explicit backends only): "
                         "prefill is sequence-sharded over cp workers, "
                         "decode untouched — DESIGN.md §9")
    ap.add_argument("--pp", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="Poisson arrival rate (req/s); 0 = closed batch")
    ap.add_argument("--prompt-lens", type=int, nargs=2, default=(8, 40))
    ap.add_argument("--decode-lens", type=int, nargs=2, default=(4, 16))
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    place = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:     # under torchrun
        device = comm.init_world(device)
        t, c, p = layout(args.backend, args.tp, args.cp, args.pp)
        place = comm.dist_groups(t, p, device, c=c)
    try:
        return _serve(args, device, place)
    finally:
        if place is not None:
            dist.destroy_process_group()


def _serve(args, device, place) -> dict:
    cfg = get_config(args.arch).reduced(num_layers=4)
    params = get_model(cfg).init(seed=0, device=device)
    out = run(cfg, params, device, backend=args.backend, tp=args.tp,
              cp=args.cp, pp=args.pp, requests=args.requests,
              slots=args.slots, rate=args.rate,
              prompt_lens=args.prompt_lens, decode_lens=args.decode_lens,
              max_len=args.max_len, place=place)
    check(out, place)
    if place is not None and dist.get_rank() > 0:
        return out
    print(f"{cfg.name}: backend={args.backend} t={out['t']} c={out['c']} "
          f"p={out['p']} slots={args.slots} requests={args.requests} "
          f"rate={args.rate or 'closed'}")
    report = out["report"]
    for m in report.metrics:
        print("  " + m.row())
    s = out["summary"]
    print(f"throughput {s['throughput_tok_s']:.1f} tok/s over "
          f"{s['wall_time_s']:.2f} s;  mean TTFT {s['ttft_mean_s']*1e3:.1f} "
          f"ms  TPOT {s['tpot_mean_s']*1e3:.2f} ms  E2E "
          f"{s['e2e_mean_s']:.2f} s")
    if report.steps:
        st = report.steps[0]
        print(f"per decode step: collectives {st.collective_counts} "
              f"(batch-invariant, asserted against commodel.comm_ops_for); "
              f"predicted wire {st.predicted_wire_bytes/1024:.1f} KiB @ "
              f"batch={args.slots}")
    print(f"analytical single-request prediction (s_p={out['s_p']}, "
          f"s_d={out['s_d']}): " + out["predicted"].row())
    if place is not None:
        print(f"{dist.get_world_size()} ranks, a process each"
              f"{' and a card each' if place.device.type == 'cuda' else ''}"
              f" ({dist.get_backend()}): every rank admitted the same "
              f"requests at rank 0's times and made the same streams")
    return out


if __name__ == "__main__":
    main()
