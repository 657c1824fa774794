"""Disaggregated prefill/decode demo: two pools, one modeled KV handoff.

Serves a mixed chat+summarize trace two ways through the SAME model
(DESIGN.md §14): colocated — one scheduler where every long prompt's
prefill chunks steal decode steps from the chat requests (head-of-line
blocking) — and disaggregated, where a 1-slot prefill pool absorbs the
long prompts and ships their finished KV pages into the decode pool's
shared ``KVPool``.  Prints each handoff (pages, bytes, and the
``commodel.kv_handoff_ops`` prediction the scheduler asserts against),
chat-request TPOT under both schedules, and the §14 planner's
colocated-vs-disagg decision for the same workload shape, then checks
the invariants end to end:

  * every stream — chat and long, both schedules — is bitwise identical
    to an undisturbed solo run of the same request;
  * measured handoff bytes equal the closed form exactly (the scheduler
    raises on any drift, so the demo finishing is itself the check);
  * clearing the prefix index drains the shared pool to zero leaked
    pages.

    PYTHONPATH=src python -m repro_torch.examples.disagg_demo --chat 6 --longs 2

Counterpart of ``examples/disagg_demo.py`` with the same flags plus
``--device`` (default the card; it raises when there is none); the
weights are drawn from seed 0 by the port's ``Model.init``.  On the card
the pools launch B2 on prefill chunks and B4 on decode steps, the
handoff exports and imports pages, and the solo runs launch B2 and B3.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.planner import plan_disagg, TrafficClass
from repro_torch.models.transformer import get_model, resolve_device
from repro_torch.runtime.backends import make_backend
from repro_torch.runtime.engine import InferenceEngine
from repro_torch.runtime.request import make_poisson_trace
from repro_torch.runtime.scheduler import DisaggScheduler, Scheduler


def run(cfg, params, device, planner_cfg, chat: int = 6, longs: int = 2,
        slots: int = 3, page_size: int = 8, chunk: int = 16, route: int = 32,
        max_len: int = 96, seed: int = 0) -> dict:
    """The trace served colocated and disaggregated, the solo streams of
    its requests (``InferenceEngine``, decode_chunk 1), the drain of the
    shared pool, and ``plan_disagg``'s best plane for the mixed workload
    on 8 chips of ``planner_cfg`` (the arch's full config)."""
    def trace():
        chats = make_poisson_trace(
            chat, 0.0, cfg.vocab_size, prompt_lens=(6, 14),
            decode_lens=(4, 8), seed=seed, quantum=2)
        long_reqs = make_poisson_trace(
            longs, 0.0, cfg.vocab_size, prompt_lens=(route, max_len - 12),
            decode_lens=(3, 6), seed=seed + 1, quantum=4)
        for r in long_reqs:
            r.rid += 100                     # chat rids < 100
        return chats + long_reqs

    # colocated: one pool, one scheduler, chunked prefill interleaved
    colo_backend = make_backend("gspmd", cfg, params, num_slots=slots,
                                max_len=max_len, paged=True,
                                page_size=page_size, device=device)
    colo = Scheduler(colo_backend, chunk_size=chunk).run(trace())
    del colo_backend

    # disaggregated: decode pool + 1-slot prefill pool on ONE KVPool,
    # disjoint owner ranges; the decode pool's prefix index receives the
    # shipped prompt blocks
    dec = make_backend("gspmd", cfg, params, num_slots=slots,
                       max_len=max_len, paged=True, page_size=page_size,
                       prefix_cache=True, device=device)
    pre = make_backend("gspmd", cfg, params, num_slots=1, max_len=max_len,
                       paged=True, page_size=page_size, pool=dec.pool,
                       owner_base=slots, device=device)
    reqs = trace()
    report = DisaggScheduler(pre, dec, chunk_size=chunk,
                             route_prompt_len=route).run(reqs)

    eng = InferenceEngine(cfg, params, max_len=max_len, decode_chunk=1,
                          device=device)
    solo = {r.rid: eng.generate(np.asarray(r.prompt)[None, :],
                                max_new_tokens=r.max_new_tokens)[0].tolist()
            for r in reqs}

    evicted = dec.prefix_index.clear()

    # the §14 decision rule at serving scale (closed form, full config)
    classes = [TrafficClass("chat", 24, 128, 4.0),
               TrafficClass("summarize", 2048, 32, 0.6)]
    best = plan_disagg(planner_cfg, 8, classes)[0]
    return {"colo": colo, "report": report, "reqs": reqs, "longs": longs,
            "solo": solo, "evicted": evicted, "stats": dec.pool.stats(),
            "free_pages": dec.pool.free_pages,
            "num_pages": dec.pool.num_pages, "best": best}


def chat_tpot(rep) -> float:
    return float(np.mean([m.tpot for m in rep.metrics
                          if m.rid < 100 and m.num_generated > 1]))


def check(out: dict) -> None:
    """The invariants of the module docstring."""
    report = out["report"]
    # invariant 1: bitwise identity vs undisturbed solo serving, both ways
    got_colo, got_dis = out["colo"].tokens_by_rid(), report.tokens_by_rid()
    for r in out["reqs"]:
        solo = out["solo"][r.rid]
        if got_colo[r.rid] != solo:
            raise AssertionError(f"rid {r.rid}: colocated diverged")
        if got_dis[r.rid] != solo:
            raise AssertionError(f"rid {r.rid}: disagg diverged")
    # invariant 2: the handoff volume sits exactly on the closed form
    # (the scheduler asserts per ship; re-check the totals here)
    if report.handoff_bytes != int(sum(h.predicted_bytes
                                       for h in report.handoffs)) or \
            len(report.handoffs) != out["longs"]:
        raise AssertionError(f"handoffs {report.handoffs}")
    # invariant 3: zero-leak drain of the SHARED pool
    stats = out["stats"]
    if stats.used_tokens != 0 or out["free_pages"] != out["num_pages"] - 1:
        raise AssertionError(
            f"shared pool leaked pages after draining the index: {stats}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32-3b")
    ap.add_argument("--chat", type=int, default=6)
    ap.add_argument("--longs", type=int, default=2)
    ap.add_argument("--slots", type=int, default=3,
                    help="decode-pool slots (the prefill pool gets 1)")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--route", type=int, default=32,
                    help="prompts >= this route through the prefill pool")
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced(num_layers=2)
    params = get_model(cfg).init(seed=0, device=device)
    out = run(cfg, params, device, get_config(args.arch), chat=args.chat,
              longs=args.longs, slots=args.slots, page_size=args.page_size,
              chunk=args.chunk, route=args.route, max_len=args.max_len,
              seed=args.seed)
    report = out["report"]
    print(f"disaggregated serve, {args.chat} chat + {args.longs} long "
          f"requests, route >= {args.route}, page {args.page_size}:")
    for h in report.handoffs:
        print(f"  handoff rid {h.rid:<4d} {h.pages} pages  "
              f"{h.bytes:>9,d} B measured == {int(h.predicted_bytes):,d} B "
              f"predicted  (prefill {1e3 * h.prefill_s:.1f} ms)")
    print(f"  chat TPOT       colocated {1e3 * chat_tpot(out['colo']):.2f} "
          f"ms, disagg decode pool {1e3 * chat_tpot(report):.2f} ms "
          f"(decode-pool clock: long prefills run elsewhere)")
    check(out)
    print(f"  drained         {out['evicted']} index entries evicted, "
          f"0 pages leaked across the pool boundary")
    print(f"  planner         mixed workload on 8 chips -> "
          f"{out['best'].name}")
    print("OK: streams bitwise identical under both schedules, handoff "
          "bytes == kv_handoff_ops closed form, zero-leak drain")
    return out


if __name__ == "__main__":
    main()
