"""The program of the ranks of ``test_torch_dist.py`` (gloo) and of
``test_torch_dist_cuda.py`` (NCCL, a card each).

A module of its own, without JAX, so that each spawned rank imports only
the port.  ``engine_run`` and ``serve_run`` are the passes both sides run:
the parent on virtual ranks (``place=None``), each rank on its real one.
``gloo_rank`` runs every layout (TP, PP and TP x PP, and the context-
parallel ones, c > 1), the quantized all-reduces and the serving runs on
one rank of a world of 4 gloo processes and writes what it holds to
``rank{r}.pkl``.  ``card_rank`` is one rank of the four-card
test at the full width of llama32-3b (or, ``small``, its CPU rehearsal
over gloo).
"""
import datetime
import os
import pickle
import time

import numpy as np
import torch

# (t, c, p): TP, TPxPP, PP, then CP, TPxCP and CPxPP
LAYOUTS = ((4, 1, 1), (2, 1, 2), (1, 1, 4), (1, 4, 1), (2, 2, 1), (1, 2, 2))
WORLD = 4
B, S, W, N = 2, 8, 24, 8                         # batch, prompt, ring, tokens
PS, PAGES = 4, 9
BT = np.array([[3, 1, 7, 5], [2, 8, 4, 6]], np.int32)
QUANT_ROWS = 4
SKEW_S = 0.05                  # rank r's own clock runs r·SKEW_S off
# (name, backend kind, its layout and options)
SERVE = (("tp", "tp", dict(t=4, paged=True, page_size=4)),
         ("pp", "pp", dict(p=4, inflight=2)),
         ("tp_cp", "tp", dict(t=2, c=2, paged=True, page_size=4)),
         ("pp_cp", "pp", dict(c=2, p=2)),
         ("pp_cp_paged", "pp", dict(c=2, p=2, paged=True, page_size=4)))


def prompt_len(c: int) -> int:
    """The prefill's prompt length: S, or at c > 1 the odd S - 1, which
    pads to a multiple of c."""
    return S if c == 1 else S - 1


def place_of(kw: dict):
    """This rank's place at a backend's layout keywords."""
    from repro_torch.core.comm import dist_groups
    return dist_groups(kw.get("t", 1), kw.get("p", 1), c=kw.get("c", 1))


def reduced_config():
    """Reduced llama32-3b, f32: d 256, 4 heads, 4 KV heads, vocab 512, on
    4 layers (pure PP at p = 4 needs a layer a stage)."""
    from repro_torch.configs import get_config
    return get_config("llama32-3b").reduced(num_layers=4)


def inputs(cfg):
    """(prompts [B, S], a paged chunk [B, S], its next tokens [B, 1]),
    int32 numpy from a seed."""
    g = np.random.default_rng(0)
    toks = g.integers(2, cfg.vocab_size, (B, S)).astype(np.int32)
    paged = g.integers(2, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return toks, paged[:, :S], paged[:, S:]


def _records(log):
    return [(r.kind, r.phase, r.shape, r.itemsize, r.t) for r in log]


def engine_run(cfg, params, t: int, p: int, place=None, c: int = 1) -> dict:
    """One layout's passes: a prefill with caches of width W (at c > 1 a
    CP prefill of the first ``prompt_len(c)`` tokens, padded), N greedy
    tokens, a paged chunk of S tokens and one paged decode step.  Returns
    numpy logits (None where this process holds none) and tokens, each
    stage's comm log as record tuples (None for a stage another process
    runs) with its length after the prefill and after the tokens, and
    the transfers (phase, count, shape, bytes), their count after the
    tokens."""
    from repro_torch.core.parallel_exec import (PipelineEngine, TPModel,
                                                pad_to_multiple, shard_params)
    toks, chunk, step = (torch.from_numpy(a) for a in inputs(cfg))
    n = prompt_len(c)
    padded = pad_to_multiple(toks[:, :n], c)
    zeros = torch.zeros(B, dtype=torch.int32)
    bt = torch.from_numpy(BT)
    with torch.inference_mode():
        if p == 1:
            model = TPModel(cfg, t, c=c, group=place and place.group,
                            cp_group=place and place.cp_group)
            shards = shard_params(cfg, params, t, model.group.local_ranks)
            logits, cache = model.cp_prefill(shards, padded, n - 1, W)
            marks = [len(model.group.log)]
            tok = torch.argmax(logits, -1).to(torch.int32)
            gen, _ = model.tp_generate(shards, cache, tok, n, N)
            marks.append(len(model.group.log))
            pools = model.init_paged_cache(PAGES, PS, "cpu")
            lg1, pools = model.tp_paged_step(shards, pools, chunk, zeros, bt)
            lg2, pools = model.tp_paged_step(shards, pools, step, zeros + S,
                                             bt)
            stages, transfers, sent = [model], [], 0
        else:
            eng = PipelineEngine(cfg, t, p, c=c, device="cpu" if place is None
                                 else None, place=place)
            staged = eng.prepare(params)
            logits, caches = eng.prefill_with_cache(staged, padded, W, n - 1)
            stages = eng.stages
            marks = [len(m.group.log) if m else None for m in stages]
            tok = eng.next_token(logits, B)
            gen, _ = eng.generate(staged, caches, tok, n, N)
            marks = [(a, len(m.group.log)) if m else None
                     for a, m in zip(marks, stages)]
            sent = len(eng.transfers)
            pools = eng.init_paged_cache(PAGES, PS)
            lg1, pools = eng.paged_pass(staged, pools, chunk, zeros, bt,
                                        "prefill")
            lg2, pools = eng.paged_pass(staged, pools, step, zeros + S, bt,
                                        "decode")
            transfers = [(r.phase, r.count, r.shape, r.bytes)
                         for r in eng.transfers]
        if p == 1:
            marks = [tuple(marks)]

    def arr(x):
        return None if x is None else x.detach().float().numpy()

    return {"prefill": arr(logits), "paged": [arr(lg1), arr(lg2)],
            "tokens": torch.cat([tok[:, None], gen], 1).numpy(),
            "logs": [m and _records(m.group.log) for m in stages],
            "marks": marks, "transfers": transfers, "sent": sent}


def quant_inputs(dtype):
    """The t = 4 ranks' inputs [QUANT_ROWS, 256] of the quantized
    all-reduce, from a seed: every process makes all four."""
    g = torch.Generator().manual_seed(5)
    return [torch.randn(QUANT_ROWS, 256, generator=g).to(dtype)
            for _ in range(4)]


def serve_trace(cfg):
    """4 requests, two at once and two later (a slot refilled)."""
    from repro_torch.runtime.request import Request
    g = np.random.default_rng(3)
    arrivals = (0.0, 0.0, 0.04, 0.12)
    return [Request(rid=i, prompt=g.integers(2, cfg.vocab_size,
                                             int(g.integers(5, 13))
                                             ).astype(np.int32),
                    max_new_tokens=int(g.integers(3, 7)), arrival=a)
            for i, a in enumerate(arrivals)]


def serve_run(cfg, params, kind: str, kw: dict, clock, place=None) -> dict:
    """The trace through ``Scheduler`` on the ``kind`` backend: per rid
    (admitted, first token, finished, tokens)."""
    from repro_torch.runtime.backends import make_backend
    from repro_torch.runtime.scheduler import Scheduler
    be = make_backend(kind, cfg, params, num_slots=2, max_len=48,
                      device="cpu" if place is None else None, place=place,
                      **kw)
    report = Scheduler(be, clock=clock).run(serve_trace(cfg))
    return {m.rid: (m.admitted, m.first_token, m.finished, list(m.tokens))
            for m in report.metrics}


class LaggingClock:
    """A virtual clock on one rank of a world whose ranks share one true
    time: it reads ``lag`` seconds behind it, ``wait_until`` idles (in
    true time) until its own reading reaches the target, and each
    reading first takes the world's latest true time (an all-reduce
    max): a rank that waits at a collective for a later one leaves when
    that one arrives."""

    def __init__(self, lag: float):
        self.true, self.lag = 0.0, lag

    def now(self) -> float:
        import torch.distributed as dist
        t = torch.tensor([self.true], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        self.true = float(t.item())
        return self.true - self.lag

    def wait_until(self, t: float) -> None:
        self.true = max(self.true, t + self.lag)


def _raises(exc, fn) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def gloo_rank(rank, world, port, params_np, out_dir):
    """One gloo rank of the world of ``world`` (= t·c·p at every
    layout)."""
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.core.comm import VirtualGroup, dist_groups
    from repro_torch.core.parallel_exec import quantized_psum
    from repro_torch.runtime.backends import make_backend
    from repro_torch.runtime.scheduler import VirtualClock

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        cfg = reduced_config()
        params = bridge.params_from_jax(params_np, cfg, device="cpu")
        out = {"layouts": {}}
        for t, c, p in LAYOUTS:
            out["layouts"][(t, c, p)] = engine_run(
                cfg, params, t, p, dist_groups(t, p, c=c), c)
        place = dist_groups(4, 1)
        out["quant"] = {}
        for dtype in (torch.float32, torch.bfloat16):
            xs = quant_inputs(dtype)
            for quant in ("int8", "fp8", "int4"):
                virtual = VirtualGroup(4)
                want = quantized_psum(xs, virtual, quant)
                got = quantized_psum([xs[rank]], place.group, quant)
                out["quant"][(quant, str(dtype))] = (
                    bool(torch.equal(got, want)),
                    _records(place.group.log) == _records(virtual.log))
                place.group.log.clear()
        xs = quant_inputs(torch.float32)
        virtual = VirtualGroup(4)
        want = virtual.collective_permute(xs)[rank]
        buf = torch.empty_like(want)
        got = place.group.collective_permute([xs[rank]], out=[buf])
        out["permute"] = (bool(torch.equal(got[0], want)), got[0] is buf,
                          _records(place.group.log) == _records(virtual.log))
        place.group.log.clear()
        # rank r's clock r·SKEW_S ahead of rank 0's, then behind it
        def ahead():
            clock = VirtualClock()
            clock.t = rank * SKEW_S
            return clock

        for name, clock in (("serve", ahead), ("serve_behind", lambda:
                                               LaggingClock(rank * SKEW_S))):
            out[name] = {}
            for serve, kind, kw in SERVE:
                out[name][serve] = serve_run(cfg, params, kind, kw, clock(),
                                             place_of(kw))
        out["guards"] = {
            "world != t·p": _raises(ValueError, lambda: dist_groups(2, 1)),
            "world != t·c·p": _raises(ValueError,
                                      lambda: dist_groups(1, 1, c=2)),
            "gloo on the card": _raises(
                RuntimeError, lambda: dist_groups(4, 1, device="cuda")),
            "backend (t, p) != place": _raises(
                ValueError, lambda: make_backend(
                    "tp", cfg, params, 2, t=2, place=place)),
            "page export": _raises(
                NotImplementedError, lambda: make_backend(
                    "tp", cfg, params, 2, t=4, paged=True,
                    place=place).export_page(1)),
        }
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the four-card ranks of test_torch_dist_cuda.py
# ---------------------------------------------------------------------------

# full width: a 333-token prefill and FORCED teacher-forced decode steps
# (phase 5's 129 positions); TIMED decode steps at SLOTS rows timed and
# profiled; a LONG-token prefill timed at LONG_LAYOUTS; f32 greedy tokens
# at L = 4
CARD = dict(prefill=333, forced=128, timed=16, slots=4, long=2048,
            f32_layers=4, f32_prompt=128, f32_new=32, seed=33)
# a CPU rehearsal of the same program (gloo, reduced llama32-3b in bf16)
SMALL = dict(prefill=33, forced=16, timed=4, slots=4, long=64, f32_layers=4,
             f32_prompt=16, f32_new=8, seed=33)
LONG_LAYOUTS = ((4, 1, 1), (1, 4, 1), (2, 2, 1), (1, 2, 2))


class Runner:
    """One layout's engine behind one interface: ``TPModel`` at p = 1,
    ``PipelineEngine`` otherwise, on virtual ranks (``place`` None) on
    ``dev`` or on this process's rank.  At c > 1 a prefill is a CP
    prefill of the prompt padded to a multiple of c, and a paged prefill
    seeds the pages from it, as the backends do."""

    def __init__(self, cfg, params, t, p, place, dev, quant=None, c=1):
        from repro_torch.core.parallel_exec import (PipelineEngine, TPModel,
                                                    shard_params)
        self.p, self.c, self.dev, self.place = p, c, dev, place
        if p == 1:
            self.m = TPModel(cfg, t, quant=quant, c=c,
                             group=place and place.group,
                             cp_group=place and place.cp_group)
            self.params = shard_params(cfg, params, t,
                                       self.m.group.local_ranks)
        else:
            self.m = PipelineEngine(cfg, t, p, c=c, quant_collectives=quant,
                                    device=None if place else dev,
                                    place=place)
            self.params = self.m.prepare(params)

    def prefill(self, tokens, width):
        """(logits of the last prompt position, caches of width at least
        ``width`` and the padded prompt's length)."""
        from repro_torch.core.parallel_exec import pad_to_multiple
        last = tokens.shape[1] - 1
        tokens = pad_to_multiple(tokens, self.c)
        width = max(width, tokens.shape[1])
        if self.p == 1:
            return self.m.cp_prefill(self.params, tokens, last, width)
        return self.m.prefill_with_cache(self.params, tokens, width, last)

    def paged_prefill(self, cache, tokens, bt, ps):
        """A paged prefill of ``tokens`` [1, S] into the pages (of
        ``ps`` positions) of ``bt``: one chunk at c = 1; at c > 1 a CP
        prefill whose cache is scattered into the pages
        (``backends.seed_cp_pages``, as the backends do)."""
        from repro_torch.runtime.backends import seed_cp_pages
        if self.c == 1:
            return self.paged(cache, tokens, torch.zeros(
                1, dtype=torch.int32, device=self.dev), bt)
        lg, small = self.prefill(tokens, 0)
        n = -(-tokens.shape[1] // self.c) * self.c
        seed_cp_pages(*(([cache], [small]) if self.p == 1
                        else (cache, small)), bt[0], n, ps)
        return lg, cache

    def decode(self, cache, tok, pos):
        if self.p == 1:
            return self.m.tp_decode_step(self.params, cache, tok, pos)
        return self.m.decode_once(self.params, cache, tok, pos)

    def paged_cache(self, pages, ps):
        if self.p == 1:
            return self.m.init_paged_cache(pages, ps, self.dev)
        return self.m.init_paged_cache(pages, ps)

    def paged(self, cache, tokens, pos, bt):
        if self.p == 1:
            return self.m.tp_paged_step(self.params, cache, tokens, pos, bt)
        return self.m.paged_pass(self.params, cache, tokens, pos, bt,
                                 "decode" if tokens.shape[1] == 1
                                 else "prefill")

    def next_token(self, logits, batch):
        if self.p == 1:
            return torch.argmax(logits, -1).to(torch.int32)
        return self.m.next_token(logits, batch)

    def sync(self):
        """Wait for the card, and on ranks for every rank."""
        import torch.distributed as dist
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        if self.place is not None:
            dist.barrier()


def forced(run, prompt, n_pre, steps, paged, start=None):
    """Teacher-forced logits [1 + steps, v] f32: a prefill (paged: one
    chunk) of the first n_pre tokens of ``prompt`` [1, n_pre + steps], then
    one decode step per next prompt token; None where the rank holds no
    logits.  ``start`` = (logits, contiguous cache) stands in for the
    prefill."""
    total, dev = n_pre + steps, prompt.device
    rows = []
    with torch.inference_mode():
        if start is not None:
            lg, cache = start
        elif paged:
            ps = 16
            n = -(-total // ps)
            cache = run.paged_cache(1 + n, ps)
            bt = torch.arange(1, 1 + n, device=dev, dtype=torch.int32)[None]
            lg, cache = run.paged_prefill(cache, prompt[:, :n_pre], bt, ps)
        else:
            lg, cache = run.prefill(prompt[:, :n_pre], total)
        rows.append(lg)
        for i in range(n_pre, total):
            if paged:
                pos = torch.full((1,), i, dtype=torch.int32, device=dev)
                lg, cache = run.paged(cache, prompt[:, i:i + 1], pos, bt)
            else:
                lg, cache = run.decode(cache, prompt[:, i], i)
            rows.append(lg)
    return None if rows[0] is None else torch.cat(rows).float()


def greedy(run, prompts, new):
    """Greedy tokens [B, new]: a prefill, then new - 1 steps."""
    with torch.inference_mode():
        S = prompts.shape[1]
        lg, cache = run.prefill(prompts, S + new)
        toks = [run.next_token(lg, prompts.shape[0])]
        for i in range(new - 1):
            lg, cache = run.decode(cache, toks[-1], S + i)
            toks.append(run.next_token(lg, prompts.shape[0]))
    return torch.stack(toks, 1)


def _busy(prof, cs):
    """(busy, busy outside NCCL) ms: the union of the kernel and copy
    intervals on the card, with and without NCCL's kernels (whose time
    holds their wait for the peers)."""
    spans = [(e.time_range.start, e.time_range.end, "nccl" in e.name.lower())
             for e in prof.events() if cs._work_on_card(e)]
    return (cs._union_us([(a, b) for a, b, _ in spans]) / 1e3,
            cs._union_us([(a, b) for a, b, n in spans if not n]) / 1e3)


def _host_top(prof, steps, n=6):
    """The host ops of the profiled window with the most self CPU time:
    [name, ms a step, calls a step]."""
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return [[e.key[:60], e.self_cpu_time_total / 1e3 / steps,
             e.count / steps] for e in host[:n]]


def _nccl_kinds(events, steps):
    """{collective: [calls a step, mean us a call]} of the NCCL kernels the
    profiler saw (their time holds any wait for the peers)."""
    out = {}
    for e in events:
        if "nccl" not in e.key.lower():
            continue
        kind = next((k for k in ("AllReduce", "AllGather", "ReduceScatter",
                                 "SendRecv", "Broadcast", "AllToAll")
                     if k.lower() in e.key.lower()), e.key[:40])
        calls, us = out.get(kind, (0, 0.0))
        out[kind] = (calls + e.count, us + e.self_device_time_total)
    return {k: [c / steps, us / c] for k, (c, us) in out.items()}


def timing(run, prompts, n_pre, steps, cs):
    """Host wall (median of 3, synchronised, no profiler) and device busy
    (the profiler's union of kernel intervals, NCCL's included) of one
    n_pre-token prefill and of a decode step at prompts.shape[0] rows,
    with the NCCL kernels of the profiled decode steps and prefill."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if run.dev.type == "cuda" else [])
    out = {}
    with torch.inference_mode():
        def prefill():
            return run.prefill(prompts[:1, :n_pre], n_pre + 1)

        walls = []
        for _ in range(4):
            run.sync()
            t0 = time.perf_counter()
            prefill()
            run.sync()
            walls.append(time.perf_counter() - t0)
        out["prefill_wall_ms"] = 1e3 * sorted(walls[1:])[1]
        with profile(activities=acts) as prof:
            prefill()
            run.sync()
        out["prefill_busy_ms"], out["prefill_busy_outside_nccl_ms"] = \
            _busy(prof, cs)
        out["prefill_nccl"] = _nccl_kinds(cs.device_events(prof), 1)

        width = n_pre + 3 * steps + 2
        lg, cache = run.prefill(prompts[:, :n_pre], width)
        tok = run.next_token(lg, prompts.shape[0])

        def decode(n, cache, tok, pos):
            for i in range(n):
                lg, cache = run.decode(cache, tok, pos + i)
                tok = run.next_token(lg, prompts.shape[0])
            return cache, tok

        cache, tok = decode(2, cache, tok, n_pre)
        run.sync()
        t0 = time.perf_counter()
        cache, tok = decode(steps, cache, tok, n_pre + 2)
        run.sync()
        out["decode_wall_ms"] = 1e3 * (time.perf_counter() - t0) / steps
        with profile(activities=acts) as prof:
            cache, tok = decode(steps, cache, tok, n_pre + 2 + steps)
            run.sync()
        busy, outside = _busy(prof, cs)
        out["decode_busy_ms"] = busy / steps
        out["decode_busy_outside_nccl_ms"] = outside / steps
        out["decode_nccl"] = _nccl_kinds(cs.device_events(prof), steps)
        out["decode_host_top"] = _host_top(prof, steps)
    return out


def nccl_micro(dev, h, rows, cs, iters=200):
    """NCCL alone on warm groups, ``iters`` calls back to back after a
    barrier, of the all-reduce of one decode step's [rows, h] bf16 on the
    t = 4 group, of the decode hop (two [rows, 1, h/t] bf16 from each rank
    of stage 0 to stage 1) at (t, p) = (1, 4) and (2, 2), and of the next
    token's broadcast (rows int32) from the last stage: host us a call
    (the loop's enqueue), wall us a call (to the card's synchronise), the
    NCCL kernels' mean us (profiler) as the host paces them
    (``kernels``), and again with every rank's card held by a
    ``torch.cuda._sleep`` until all ``iters`` calls are queued
    (``queued``): the kernels then run back to back, so their mean is
    the collective's own time, without a wait for a later rank's host."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.comm import dist_groups

    def measure(fn):
        for _ in range(10):
            fn()
        torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        kinds = []
        for hold_ms in (0, 2e3 * (t1 - t0) + 20):
            dist.barrier()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                if hold_ms:
                    torch.cuda._sleep(int(hold_ms * cs._cycles_per_ms()))
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize(dev)
            kinds.append(_nccl_kinds(cs.device_events(prof), iters))
        dist.barrier()
        return {"host_us": 1e6 * (t1 - t0) / iters,
                "wall_us": 1e6 * (t2 - t0) / iters, "kernels": kinds[0],
                "queued": kinds[1]}

    out = {}
    place = dist_groups(4, 1, dev)
    x = torch.zeros(rows, h, dtype=torch.bfloat16, device=dev)
    out["allreduce"] = measure(lambda: dist.all_reduce(x,
                                                       group=place.group.pg))
    out["allreduce"]["bytes"] = x.numel() * x.element_size()
    for t, p in ((1, 4), (2, 2)):
        place = dist_groups(t, p, dev)
        pair = [torch.zeros(rows, 1, h // t, dtype=torch.bfloat16,
                            device=dev) for _ in range(2)]

        def hop():
            if place.stage == 0:
                op, peer = dist.isend, place.next
            elif place.stage == 1:
                op, peer = dist.irecv, place.prev
            else:
                return
            for req in dist.batch_isend_irecv(
                    [dist.P2POp(op, x, peer) for x in pair]):
                req.wait()

        key = f"hop t={t} p={p}"
        out[key] = measure(hop)
        out[key]["bytes"] = 2 * pair[0].numel() * pair[0].element_size()
    tok = torch.zeros(rows, dtype=torch.int32, device=dev)
    out["broadcast"] = measure(lambda: dist.broadcast(tok,
                                                      src=place.last_rank))
    return out


# serve_demo's layouts on the four cards: (name, backend, flags)
SERVE_DEMO = (("tp", "tp", dict(tp=4)), ("pp", "pp", dict(pp=4)),
              ("tp_cp4", "tp", dict(tp=1, cp=4)))


def long_prefill(run, prompt, layers, cs):
    """One ``prompt``-long prefill (width + 1): host wall (median of 3
    after a warm-up, synchronised, no profiler; on ranks each timed pass
    starts after a barrier), the profiled pass's busy with and without
    NCCL's kernels, its NCCL kernels by collective, and their SendRecv
    time over the ``layers`` of this stage: the ring's per layer (at
    p > 1 the stage hop's one send/recv pair with it)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if run.dev.type == "cuda" else [])
    out = {"tokens": prompt.shape[1]}
    with torch.inference_mode():
        walls = []
        for _ in range(4):
            run.sync()
            t0 = time.perf_counter()
            run.prefill(prompt, prompt.shape[1] + 1)
            run.sync()
            walls.append(time.perf_counter() - t0)
        out["wall_ms"] = 1e3 * sorted(walls[1:])[1]
        with profile(activities=acts) as prof:
            run.prefill(prompt, prompt.shape[1] + 1)
            run.sync()
        out["busy_ms"], out["busy_outside_nccl_ms"] = _busy(prof, cs)
        out["nccl"] = _nccl_kinds(cs.device_events(prof), 1)
    calls, us = out["nccl"].get("SendRecv", (0, 0.0))
    out["sendrecv_ms_per_layer"] = calls * us / 1e3 / layers
    return out


def card_rank(rank, world, port, out_path, small=False, setup=None,
              focus=None):
    """One rank of the four-card test (NCCL, card ``rank``; with ``small``
    a CPU rehearsal over gloo at reduced width).  Per layout: the
    teacher-forced contiguous and paged runs (and at t = 4 the int8 runs
    from the virtual prefill and from the ranks' own) with this rank's
    launches and, on the last stage, the top-1 match and drift against
    the virtual engine's logits (computed on card 0 and broadcast); the
    timings of this rank and (rank 0) of the virtual engine on one card,
    and at ``LONG_LAYOUTS`` a long prefill's (``long_prefill``).  Then
    the int8/fp8/int4 all-reduce at [4, h] bf16 against the virtual
    group on the same card, f32 greedy tokens at L = 4 against the
    virtual engine, and serve_demo on ranks against its one-process run.
    ``focus`` ({(t, c, p): (mode, ...)}) reruns only those layouts' modes,
    untimed, and nothing after them.  Rank 0 writes every rank's rows as
    JSON."""
    import dataclasses

    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.comm import VirtualGroup, dist_groups
    from repro_torch.core.parallel_exec import (quantized_psum,
                                                stage_layer_range)
    from repro_torch.examples import serve_demo
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import get_model

    if setup is not None:
        setup()
    opt = SMALL if small else CARD
    torch.set_num_threads(1)            # torchrun's default a rank
    if small:
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo" if small else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=10))
    rows = {"rank": rank, "layouts": {},
            "env": {k: v for k, v in os.environ.items()
                    if "NCCL" in k or k.startswith("CUDA_")}}
    try:
        cfg = get_config(cs.ARCH)
        if small:
            cfg = dataclasses.replace(cfg.reduced(num_layers=4),
                                      dtype="bfloat16")
        L = cfg.num_layers
        params = get_model(cfg).init(seed=0, device=dev)
        n_pre, steps = opt["prefill"], opt["forced"]
        g = torch.Generator().manual_seed(opt["seed"])
        prompt = torch.randint(2, cfg.vocab_size, (1, n_pre + steps),
                               generator=g).to(dev)
        prompts = torch.randint(2, cfg.vocab_size, (opt["slots"], n_pre),
                                generator=g).to(dev)
        long_prompt = torch.randint(2, cfg.vocab_size, (1, opt["long"]),
                                    generator=g).to(dev)
        for t, c, p in LAYOUTS if focus is None else focus:
            place = dist_groups(t, p, dev, c=c)
            lo, hi = stage_layer_range(cfg, p, place.stage)
            row = {"stage": place.stage, "lo": lo, "hi": hi, "runs": {}}
            # (name, quant, paged, from the virtual prefill): the int8
            # decode from the virtual engine's prefill, which every rank
            # makes on its own card, has exact collectives and is held
            # bitwise to the virtual int8 engine; from the ranks' own
            # prefill it is held to the virtual unquantized engine
            modes = [("contiguous", None, False, False),
                     ("paged", None, True, False)]
            if p == 1 and t > 1 and c == 1:
                modes += [("int8", "int8", False, True),
                          ("int8_own", "int8", False, False)]
            if focus is not None:
                modes = [m for m in modes if m[0] in focus[(t, c, p)]]
            refs = {}
            for name, quant, paged, from_virtual in modes:
                start = vstart = None
                if from_virtual:
                    with torch.inference_mode():
                        vrun = Runner(cfg, params, t, p, None, dev, c=c)
                        vstart = vrun.prefill(prompt[:, :n_pre],
                                              n_pre + steps)
                        del vrun
                    start = (vstart[0], [{k: v.clone() for k, v in
                                          vstart[1][rank].items()}])
                run = Runner(cfg, params, t, p, place, dev, quant, c)
                _build.reset_launches()
                got = forced(run, prompt, n_pre, steps, paged, start)
                run.sync()
                launches = dict(_build.LAUNCHES)
                cp = int(c > 1)
                want = cs.rank_launches(
                    L, lo, hi, passes=1 + steps - from_virtual - cp,
                    flash=0 if from_virtual or cp else 1,
                    decode=0 if paged else steps,
                    paged=steps if paged else 0, t=t, quant=quant,
                    quant_steps=steps if quant else 0, cp=cp)
                del run
                key = (quant if from_virtual else None, paged)
                if key not in refs:
                    ref = torch.empty((1 + steps, cfg.padded_vocab),
                                      device=dev)
                    if rank == 0:
                        ref = forced(Runner(cfg, params, t, p, None, dev,
                                            key[0], c),
                                     prompt, n_pre, steps, paged, vstart)
                    dist.broadcast(ref, src=0)
                    refs[key] = ref
                ref = refs[key]
                out = {"launches": launches, "want_launches": want}
                if got is not None:
                    match, drift = cs.agreement(got, ref)
                    out.update(match=match, drift=drift,
                               bitwise=bool(torch.equal(got, ref)),
                               finite=bool(torch.isfinite(got).all()))
                row["runs"][name] = out
            del refs
            if focus is None:
                row["timing"] = timing(Runner(cfg, params, t, p, place,
                                              dev, c=c),
                                       prompts, n_pre, opt["timed"], cs)
                if rank == 0:
                    row["virtual_timing"] = timing(
                        Runner(cfg, params, t, p, None, dev, c=c), prompts,
                        n_pre, opt["timed"], cs)
            if focus is None and (t, c, p) in LONG_LAYOUTS:
                row["long"] = long_prefill(
                    Runner(cfg, params, t, p, place, dev, c=c), long_prompt,
                    hi - lo, cs)
                if rank == 0:
                    row["virtual_long"] = long_prefill(
                        Runner(cfg, params, t, p, None, dev, c=c),
                        long_prompt, L, cs)
            dist.barrier()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            rows["layouts"]["{}-{}-{}".format(t, c, p)] = row
        if focus is not None:
            _gather_rows(rank, world, rows, out_path)
            return
        if rank == 0:               # the long prefill on one card, c = 1
            rows["one_card_long"] = long_prefill(
                Runner(cfg, params, 1, 1, None, dev), long_prompt, L, cs)
        dist.barrier()
        if dev.type == "cuda":
            rows["nccl"] = nccl_micro(dev, cfg.d_model, opt["slots"], cs)
        # the quantized all-reduces at one decode step's [4, h] bf16
        place = dist_groups(4, 1, dev)
        gq = torch.Generator(device=dev).manual_seed(11)
        xs = [torch.randn(opt["slots"], cfg.d_model, generator=gq,
                          device=dev).to(torch.bfloat16) for _ in range(4)]
        rows["quant"] = {}
        for quant in ("int8", "fp8", "int4"):
            got = quantized_psum([xs[rank]], place.group, quant)
            want = quantized_psum(xs, VirtualGroup(4), quant)
            rows["quant"][quant] = bool(torch.equal(got, want))
        del params
        # f32 at L = 4: greedy tokens against the virtual engine
        cfg32 = dataclasses.replace(cfg, num_layers=opt["f32_layers"],
                                    dtype="float32")
        p32 = get_model(cfg32).init(seed=3, device=dev)
        prompts32 = torch.randint(2, cfg.vocab_size,
                                  (2, opt["f32_prompt"]),
                                  generator=torch.Generator().manual_seed(4)
                                  ).to(dev)
        rows["f32_tokens"] = {}
        for t, c, p in LAYOUTS:
            place = dist_groups(t, p, dev, c=c)
            got = greedy(Runner(cfg32, p32, t, p, place, dev, c=c),
                         prompts32, opt["f32_new"])
            want = greedy(Runner(cfg32, p32, t, p, None, dev, c=c),
                          prompts32, opt["f32_new"])
            rows["f32_tokens"]["{}-{}-{}".format(t, c, p)] = \
                bool(torch.equal(got, want))
        del p32
        # serve_demo on ranks against its one-process run (f32, L = 4)
        sd_cfg = get_config(cs.ARCH).reduced(num_layers=4)
        sd_params = get_model(sd_cfg).init(seed=0, device=dev)
        rows["serve_demo"] = {}
        for name, backend, kw in SERVE_DEMO:
            t, c, p = serve_demo.layout(backend, **kw)
            place = dist_groups(t, p, dev, c=c)
            out = serve_demo.run(sd_cfg, sd_params, dev, backend,
                                 place=place, **kw)
            serve_demo.check(out, place)
            one = serve_demo.run(sd_cfg, sd_params, dev, backend, **kw)
            rows["serve_demo"][name] = {
                "streams_equal": {m.rid: m.tokens for m in
                                  out["report"].metrics}
                == {m.rid: m.tokens for m in one["report"].metrics},
                "requests": len(out["report"].metrics),
                "tokens": out["report"].total_tokens}
        _gather_rows(rank, world, rows, out_path)
    finally:
        dist.destroy_process_group()


def _gather_rows(rank, world, rows, out_path):
    """Every rank's rows; rank 0 writes them as JSON."""
    import json

    import torch.distributed as dist
    every = [None] * world
    dist.all_gather_object(every, rows)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(every, f)
