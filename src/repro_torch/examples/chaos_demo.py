"""Chaos demo: the serving layer surviving a seeded fault schedule.

Runs the continuous-batching scheduler (runtime/scheduler.py) in
``admission="optimistic"`` mode on an oversubscribed KV page pool with a
seeded ``runtime.faults.FaultInjector`` attached — transient decode/prefill
failures (retried with backoff), injected pool exhaustion (recovered by
preemption-by-recompute), and, for verification, the same trace served
fault-free.  Prints which faults were injected, how each request finished,
and checks the two robustness invariants end to end (DESIGN.md §10):

  * every request that finished normally has a token stream bitwise
    identical to the undisturbed run (greedy determinism + recompute);
  * the page pool drains to zero leaked pages whatever the fault schedule
    did.

    PYTHONPATH=src python -m repro_torch.examples.chaos_demo --seed 3 --requests 6

Counterpart of ``examples/chaos_demo.py`` with the same flags plus
``--device`` (default the card; it raises when there is none); the
weights are drawn from seed 0 by the port's ``Model.init``.  On the card
the paged backend launches B2 on each prefill and recompute and B4 on
each decode step.
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.models.transformer import get_model, resolve_device
from repro_torch.runtime.backends import make_backend
from repro_torch.runtime.faults import FaultInjector
from repro_torch.runtime.request import make_poisson_trace
from repro_torch.runtime.scheduler import Scheduler, VirtualClock


def run(cfg, params, device, seed: int = 0, requests: int = 6,
        slots: int = 3, max_len: int = 64, page_size: int = 4,
        decode_rate: float = 0.05, pool_rate: float = 0.10) -> dict:
    """The trace served fault-free and under the seeded fault schedule,
    both on the virtual clock with optimistic admission on an
    oversubscribed pool.  Returns both reports, the injector and the
    faulted backend's pool."""
    def trace():
        return make_poisson_trace(requests, 0.0, cfg.vocab_size,
                                  prompt_lens=(5, 12), decode_lens=(4, 12),
                                  seed=0)

    def paged_backend():
        # ~60% of worst-case page parity: optimistic admission must preempt
        per_slot = -(-max_len // page_size)
        return make_backend("gspmd", cfg, params, num_slots=slots,
                            max_len=max_len, paged=True,
                            page_size=page_size,
                            num_pages=1 + slots * per_slot * 3 // 5,
                            device=device)

    # fault-free reference run (same trace, same backend shape)
    ref = Scheduler(paged_backend(), clock=VirtualClock(),
                    admission="optimistic").run(trace())

    inj = FaultInjector(seed=seed,
                        rates={"decode": decode_rate,
                               "prefill": decode_rate,
                               "pool": pool_rate},
                        transient_frac=0.7, max_faults=16)
    backend = paged_backend()
    sched = Scheduler(backend, clock=VirtualClock(),
                      admission="optimistic", faults=inj,
                      retry_backoff=1e-3)
    report = sched.run(trace())
    return {"ref": ref, "report": report, "injector": inj,
            "pool": backend.pool}


def survivors(out: dict):
    return [m for m in out["report"].metrics
            if m.finish_reason in ("length", "eos")]


def check(out: dict) -> None:
    """The two invariants of the module docstring."""
    refs = out["ref"].tokens_by_rid()
    diverged = [m.rid for m in survivors(out) if m.tokens != refs[m.rid]]
    if diverged:
        raise AssertionError(f"survivor streams diverged: {diverged}")
    pool = out["pool"]
    if pool.stats().used_tokens != 0 or pool.owners():
        raise AssertionError("pool leaked pages")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32-3b")
    ap.add_argument("--seed", type=int, default=0,
                    help="fault-schedule seed (the run is a pure function "
                         "of it — rerun with the same seed to reproduce)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=4)
    ap.add_argument("--decode-rate", type=float, default=0.05)
    ap.add_argument("--pool-rate", type=float, default=0.10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced(num_layers=2)
    params = get_model(cfg).init(seed=0, device=device)
    out = run(cfg, params, device, seed=args.seed, requests=args.requests,
              slots=args.slots, max_len=args.max_len,
              page_size=args.page_size, decode_rate=args.decode_rate,
              pool_rate=args.pool_rate)
    report, inj, pool = out["report"], out["injector"], out["pool"]
    print(f"{cfg.name}: {args.requests} requests, {args.slots} slots, "
          f"oversubscribed pool ({pool.num_pages} pages × "
          f"{args.page_size}), fault seed {args.seed}")
    print(f"injected {len(inj.injected)} faults: " + (", ".join(
        f"{site}@{idx}:{f.kind}" for site, idx, f in inj.injected) or "none"))
    for m in report.metrics:
        print("  " + m.row())
    s = report.summary()
    print(f"preemptions {s['preemptions']}  retries {s['retries']}  "
          f"shed {s['shed']}  total tokens {s['total_tokens']}")
    check(out)
    stats = pool.stats()
    print(f"OK: {len(survivors(out))}/{args.requests} survivors bitwise "
          f"identical to the fault-free run; pool drained clean "
          f"({stats.free_pages}/{stats.num_pages - 1} usable pages free)")
    return out


if __name__ == "__main__":
    main()
