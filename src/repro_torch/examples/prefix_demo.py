"""Prefix-cache demo: cross-request KV reuse with copy-on-write pages.

Serves a zipf-distributed template-heavy trace (``make_template_trace`` —
the production shape where thousands of users share a handful of system
prompts) twice through the SAME paged backend + scheduler: a cold pass
that writes and indexes every template, then a hit pass whose requests
adopt the cached template pages and chunk-prefill only their novel
suffixes (DESIGN.md §13).  Prints the hit rate, the prefill chunks and
collectives actually executed vs what a cold serve would have issued
(``commodel.prefix_cache_ops``), and cold-vs-hit TTFT, then checks the
three invariants end to end:

  * every hit stream is bitwise identical to an undisturbed solo run of
    the same request (adopted KV == recomputed KV, COW included);
  * executed prefill chunks equal the per-request suffix arithmetic;
  * clearing the index drains the pool to zero leaked pages.

    PYTHONPATH=src python -m repro_torch.examples.prefix_demo --requests 8 --slots 2

Counterpart of ``examples/prefix_demo.py`` with the same flags plus
``--device`` (default the card; it raises when there is none); the
weights are drawn from seed 0 by the port's ``Model.init``.  On the card
a suffix chunk launches B2 at the hit's offset, a one-token suffix and
each decode step B4 over the pages, and the solo runs B2 and B3.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import commodel as cm
from repro_torch.models.transformer import get_model, resolve_device
from repro_torch.runtime.backends import make_backend
from repro_torch.runtime.engine import InferenceEngine
from repro_torch.runtime.request import make_template_trace
from repro_torch.runtime.scheduler import Scheduler


def run(cfg, params, device, requests: int = 8, slots: int = 2,
        max_len: int = 96, page_size: int = 8, chunk: int = 8,
        templates: int = 2, template_len: int = 24, seed: int = 0) -> dict:
    """The cold pass and the hit pass of one template trace through one
    paged backend with the prefix cache, the solo streams of the hit
    pass's requests (``InferenceEngine``, decode_chunk 1), and the drain
    of the index.  Returns both reports, the hits, the chunk counts, the
    skipped-collectives arithmetic, the solo streams and the pool's
    stats after the drain."""
    def trace(rid_base=0):
        reqs = make_template_trace(
            requests, 0.0, cfg.vocab_size, n_templates=templates,
            template_len=template_len, suffix_lens=(3, 7),
            decode_lens=(3, 6), seed=seed)
        for r in reqs:
            r.rid += rid_base
        return reqs

    backend = make_backend("gspmd", cfg, params, num_slots=slots,
                           max_len=max_len, paged=True, page_size=page_size,
                           prefix_cache=True, device=device)
    # wall clock (not VirtualClock): the cold-vs-hit TTFT delta is the
    # demo's headline number and only exists in real time
    sched = Scheduler(backend, chunk_size=chunk)

    # cold pass: writes the template pages and indexes every full block
    cold = sched.run(trace(rid_base=0))
    # hit pass: identical prompt distribution, fresh rids — every request
    # now finds its whole template in the index
    reqs = trace(rid_base=1000)
    report = sched.run(reqs)
    hits = {m.rid: m.cached_prefix_len for m in report.metrics
            if m.cached_prefix_len > 0}

    # skipped collectives at the modal request shape (whole template hit)
    mean_suffix = int(np.mean(
        [m.prompt_len - m.cached_prefix_len for m in report.metrics]))
    ops = cm.prefix_cache_ops(cfg, template_len, max(1, mean_suffix),
                              chunk=chunk)

    eng = InferenceEngine(cfg, params, max_len=max_len, decode_chunk=1,
                          device=device)
    solo = {r.rid: eng.generate(np.asarray(r.prompt)[None, :],
                                max_new_tokens=r.max_new_tokens)[0].tolist()
            for r in reqs}

    evicted = backend.prefix_index.clear()
    return {"cold": cold, "report": report, "reqs": reqs, "hits": hits,
            "cold_chunks": sum(s.phase == "prefill" for s in cold.steps),
            "hit_chunks": sum(s.phase == "prefill" for s in report.steps),
            "chunk": chunk, "ops": ops, "solo": solo, "evicted": evicted,
            "stats": backend.pool.stats(),
            "free_pages": backend.pool.free_pages,
            "num_pages": backend.pool.num_pages}


def pass_ttfts(rep, rids=None):
    """TTFT relative to each pass's own epoch: the scheduler's wall clock
    keeps running between run() calls while the trace's arrival=0 does
    not, so raw m.ttft would charge the hit pass for the cold pass's wall
    time."""
    epoch = min(m.admitted for m in rep.metrics)
    return [m.first_token - epoch for m in rep.metrics
            if rids is None or m.rid in rids]


def check(out: dict) -> None:
    """The three invariants of the module docstring."""
    got = out["report"].tokens_by_rid()
    # invariant 1: bitwise token identity vs undisturbed solo serving
    for r in out["reqs"]:
        if got[r.rid] != out["solo"][r.rid]:
            raise AssertionError(
                f"request {r.rid}: cache-hit stream diverged from solo run")
    # invariant 2: executed chunks == per-request suffix arithmetic
    want = sum(-(-(m.prompt_len - m.cached_prefix_len) // out["chunk"])
               for m in out["report"].metrics)
    if out["hit_chunks"] != want:
        raise AssertionError(f"{out['hit_chunks']} prefill chunks executed, "
                             f"suffix math says {want}")
    # invariant 3: zero-leak drain once the index lets go
    stats = out["stats"]
    if stats.used_tokens != 0 or out["free_pages"] != out["num_pages"] - 1:
        raise AssertionError(
            f"pool leaked pages after draining the index: {stats}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32-3b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--templates", type=int, default=2)
    ap.add_argument("--template-len", type=int, default=24,
                    help="shared system-prompt length (3 pages at the "
                         "default page size)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced(num_layers=2)
    params = get_model(cfg).init(seed=0, device=device)
    out = run(cfg, params, device, requests=args.requests, slots=args.slots,
              max_len=args.max_len, page_size=args.page_size,
              chunk=args.chunk, templates=args.templates,
              template_len=args.template_len, seed=args.seed)
    hits, reqs, ops = out["hits"], out["reqs"], out["ops"]

    print(f"prefix cache over {args.requests} requests, "
          f"{args.templates} templates × {args.template_len} tokens, "
          f"page {args.page_size}, chunk {args.chunk}:")
    print(f"  hit rate        {len(hits)}/{len(reqs)} "
          f"({100.0 * len(hits) / len(reqs):.0f}%), "
          f"{sum(hits.values())} prompt positions adopted")
    print(f"  prefill chunks  cold pass {out['cold_chunks']}, "
          f"hit pass {out['hit_chunks']}")
    print(f"  per-hit comm    skipped {ops.skipped_bytes:,.0f} wire bytes "
          f"({ops.skipped_counts or 'no collectives at t=1'}), executed "
          f"{ops.executed_bytes:,.0f}")
    print(f"  TTFT mean       cold "
          f"{1e3 * np.mean(pass_ttfts(out['cold'])):.1f} ms, hit "
          f"{1e3 * np.mean(pass_ttfts(out['report'], hits)):.1f} ms")
    check(out)
    print(f"  drained         {out['evicted']} index entries evicted, "
          f"0 pages leaked, {out['stats'].cow_copies} COW copies over the "
          f"run")
    print("OK: hit streams bitwise identical, suffix-only prefill, "
          "zero-leak drain")
    return out


if __name__ == "__main__":
    main()
