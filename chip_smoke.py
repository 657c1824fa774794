#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py            # every phase, one card

Phases:
  1. the card's name and power limit, and the kernels' build time;
  2. each hand-written kernel (B1 RMSNorm, B2 flash prefill, B3 contiguous
     and B4 paged flash-decode) against its plain PyTorch version at the
     main path's shapes, in bf16 and f32, with the tolerance stated; times
     of the kernel, the plain version and one library call computing the
     same function, beside the card's bound for the work;
  3. the serving path at the full width of llama32-3b (random weights from
     a seed, made on the card): InferenceEngine.generate, the contiguous
     Scheduler and the paged Scheduler with chunked prefill;
  4. the kernel path against the plain path on the whole model;
  5. one JSON line with the kernel table, then the ok line.

It imports nothing of JAX, exits non-zero with no ok line when there is no
card or when it is not inside a checkout of the repository, and lets every
phase's error end the run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # f32 outside the tensor cores
# max |kernel - plain| <= ATOL + RTOL * |plain|, elementwise
TOLERANCE = {
    # bf16: both sides compute in f32 from the same bf16 inputs and round
    # the output once; they may land one bf16 ulp apart (2^-8 relative)
    "bfloat16": (1e-2, 1e-2),
    # f32: only the order of the f32 sums differs
    "float32": (1e-4, 1e-4),
}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


_CYCLES_PER_MS = []


def _cycles_per_ms() -> float:
    """The SM clock as torch.cuda._sleep counts it, measured once."""
    if not _CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(10_000_000)
        stop.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS.append(10_000_000 / start.elapsed_time(stop))
    return _CYCLES_PER_MS[0]


def bench(fn, arg_sets, iters: int = 50, warmup: int = 3) -> float:
    """Mean device ms per call of fn(*args) over ``iters`` calls, cycling
    through ``arg_sets`` (copies of the inputs large enough together to
    leave the 50 MB L2 cold for each call), timed with CUDA events.

    A short kernel finishes before Python issues the next one, so timing
    back-to-back calls would measure the host.  The stream is first held
    busy (torch.cuda._sleep) for twice the time the host needs to issue
    the calls, so they queue up and the events see only device time."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    issue_ms = 1e3 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * issue_ms * _cycles_per_ms()))
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def copies(args, nbytes: int, budget: int = 160 << 20):
    """Enough copies of ``args`` to exceed the L2 several times over."""
    n = max(1, min(32, -(-budget // max(nbytes, 1))))
    return [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args) for _ in range(n - 1)]


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def compare(name, got, want, dtype: str) -> float:
    """Max abs error of got vs want; raises past the stated tolerance."""
    atol, rtol = TOLERANCE[dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    worst = float((err / (atol + rtol * w.abs())).max())
    max_abs = float(err.max())
    rel = max_abs / max(float(w.abs().max()), 1e-30)
    log(f"  {name:<44s} {dtype:8s} max_abs_err {max_abs:.3e}  "
        f"max_rel_err {rel:.3e}  (tol {atol:g} + {rtol:g}|ref|: "
        f"{'ok' if worst <= 1 else 'FAIL'})")
    if not bool(torch.isfinite(g).all()) or worst > 1:
        raise AssertionError(f"{name} [{dtype}] disagrees with its plain "
                             f"version: max_abs_err {max_abs:.3e}")
    return max_abs


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

FULL = dict(h=3072, Hq=24, Hkv=8, D=128)
DECODE_LENGTHS = (1, 17, 300, 1024)


def kernel_phase(dev, iters: int):
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_cuda, paged_decode_attention_cuda)
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rmsnorm.ops import rms_norm_cuda
    from repro_torch.kernels.rmsnorm.ref import rms_norm_ref

    g = torch.Generator(device=dev).manual_seed(0)
    h, Hq, Hkv, D = FULL["h"], FULL["Hq"], FULL["Hkv"], FULL["D"]
    i32 = dict(device=dev, dtype=torch.int32)
    rows = {}

    def randn(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    def ints(vals):
        return torch.tensor(vals, **i32)

    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).replace("torch.", "")
        log(f"[kernels] {dname}")
        # -- B1 RMSNorm: decode rows (4) and a ragged prefill (333) --------
        err = 0.0
        for nrow in (4, 333):
            x = randn((nrow, h), dt)
            w = randn((h,), dt, 0.1)
            err = max(err, compare(f"B1 rmsnorm rows={nrow} h={h}",
                                   rms_norm_cuda(x, w), rms_norm_ref(x, w),
                                   dname))
        rows.setdefault("rmsnorm", {})[dname] = dict(
            err=err, x=x, w=w, shape=f"x[{nrow},{h}]")
        # -- B2 flash prefill: S in {128, 333}, a window, a paged chunk ---
        cases = [(1, 128, 128, [0], [128], None),
                 (1, 333, 333, [0], [333], None),
                 (2, 333, 333, [0, 0], [333, 333], 100),
                 # a chunk of 256 at pos 300 over the gathered 64-page view
                 (1, 256, 1024, [300], [556], None)]
        err = 0.0
        for B, S, T, off, kl, win in cases:
            q = randn((B, S, Hq, D), dt)
            k = randn((B, T, Hkv, D), dt)
            v = randn((B, T, Hkv, D), dt)
            err = max(err, compare(
                f"B2 flash B={B} S={S} T={T} off={off[0]} win={win}",
                flash_attention_cuda(q, k, v, ints(off), ints(kl), win),
                flash_attention_ref(q, k, v, ints(off), ints(kl), win),
                dname))
            if S == 333 and win is None:
                timed = dict(args=(q, k, v, ints(off), ints(kl), None),
                             shape=f"q[{B},{S},{Hq},{D}] kv[{B},{T},{Hkv},{D}]")
        rows.setdefault("flash_attention", {})[dname] = dict(err=err, **timed)
        # -- B3 contiguous decode: B = 4, W = 1024, ragged lengths --------
        B, W = 4, 1024
        q = randn((B, Hq, D), dt)
        k = randn((B, W, Hkv, D), dt)
        v = randn((B, W, Hkv, D), dt)
        lens = ints(DECODE_LENGTHS)
        err = compare(f"B3 decode B={B} W={W} len={DECODE_LENGTHS}",
                      decode_attention_cuda(q, k, v, lens),
                      dref.decode_attention_ref(q, k, v, lens), dname)
        rows.setdefault("decode_attention", {})[dname] = dict(
            err=err, args=(q, k, v, lens),
            shape=f"q[{B},{Hq},{D}] kv[{B},{W},{Hkv},{D}]")
        # -- B4 paged decode: ps = 16, shuffled table, scratch rows -------
        ps, n = 16, W // 16
        P = 1 + B * n
        perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(1)) + 1
        bt = perm.reshape(B, n).to(**i32).contiguous()
        kp = randn((P, ps, Hkv, D), dt)
        vp = randn((P, ps, Hkv, D), dt)
        err = compare(f"B4 paged B={B} ps={ps} n={n} len={DECODE_LENGTHS}",
                      paged_decode_attention_cuda(q, kp, vp, bt, lens),
                      dref.paged_decode_attention_ref(q, kp, vp, bt, lens),
                      dname)
        # an inactive slot: table row of scratch page 0, garbage position
        bt0 = bt.clone()
        bt0[1] = 0
        lens0 = ints([1, 1, 300, 1024])
        err = max(err, compare(
            "B4 paged with a scratch-page row",
            paged_decode_attention_cuda(q, kp, vp, bt0, lens0),
            dref.paged_decode_attention_ref(q, kp, vp, bt0, lens0), dname))
        rows.setdefault("paged_decode_attention", {})[dname] = dict(
            err=err, args=(q, kp, vp, bt, lens),
            shape=f"q[{B},{Hq},{D}] pages[{P},{ps},{Hkv},{D}] bt[{B},{n}]")
        torch.cuda.synchronize()

    # -- timing, in bf16 (the main path's type) and f32 ------------------
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).replace("torch.", "")
        esz = torch.empty((), dtype=dt).element_size()
        # B1
        r = rows["rmsnorm"][dname]
        x, w = r["x"], r["w"]
        nbytes = (2 * x.numel() + w.numel()) * esz
        sets = copies((x, w), nbytes)
        w1 = [(a, 1.0 + b) for a, b in sets]
        t = dict(
            kernel=bench(rms_norm_cuda, sets, iters),
            plain=bench(rms_norm_ref, sets, iters),
            library=bench(lambda a, b: F.rms_norm(a, (h,), b, 1e-5), w1,
                          iters))
        t["bound"], t["by"] = bound_ms(nbytes, 4.0 * x.numel(), "float32")
        out.setdefault("rmsnorm", {})[dname] = t
        # B2
        r = rows["flash_attention"][dname]
        q, k, v, off, kl, _ = r["args"]
        B, S = q.shape[:2]
        pairs = B * S * (S + 1) // 2
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * esz
        sets = copies((q, k, v, off, kl), nbytes)
        lib_sets = [(a.transpose(1, 2).contiguous(),
                     b.transpose(1, 2).contiguous(),
                     c.transpose(1, 2).contiguous()) for a, b, c, *_ in sets]
        t = dict(
            kernel=bench(flash_attention_cuda, sets, iters),
            plain=bench(flash_attention_ref, sets, max(3, iters // 10)),
            library=bench(lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, is_causal=True, enable_gqa=True), lib_sets, iters))
        t["bound"], t["by"] = bound_ms(nbytes, 4.0 * D * Hq * pairs, dname)
        out.setdefault("flash_attention", {})[dname] = t
        # B3 / B4: bytes of the cache rows the lengths name
        live = sum(min(x, W) for x in DECODE_LENGTHS)
        flops = 4.0 * D * Hq * live
        kv_bytes = 2 * live * Hkv * D * esz
        for name, fn, pfn in (
                ("decode_attention", decode_attention_cuda,
                 dref.decode_attention_ref),
                ("paged_decode_attention", paged_decode_attention_cuda,
                 dref.paged_decode_attention_ref)):
            args = rows[name][dname]["args"]
            q = args[0]
            nbytes = 2 * q.numel() * esz + kv_bytes
            sets = copies(args, sum(a.numel() * a.element_size()
                                    for a in args))
            # the library call reads a [B,Hkv,T,D] view; B4's is gathered
            # from the pages before timing
            lib_sets = []
            for a, *kv, d in sets:
                if name == "decode_attention":
                    kg, vg = kv
                else:
                    kp, vp, bt = kv
                    kg = kp[bt.long()].flatten(1, 2)
                    vg = vp[bt.long()].flatten(1, 2)
                m = (torch.arange(kg.shape[1], device=dev)[None, :]
                     < d[:, None])[:, None, None, :]
                lib_sets.append((a[:, :, None].contiguous(),
                                 kg.transpose(1, 2).contiguous(),
                                 vg.transpose(1, 2).contiguous(), m))
            t = dict(
                kernel=bench(fn, sets, iters),
                plain=bench(pfn, sets, max(3, iters // 10)),
                library=bench(lambda a, b, c, m: F.scaled_dot_product_attention(
                    a, b, c, attn_mask=m, enable_gqa=True), lib_sets, iters))
            t["bound"], t["by"] = bound_ms(nbytes, flops, dname)
            out.setdefault(name, {})[dname] = t
        for name in out:
            t = out[name][dname]
            log(f"  time {name:<24s} {dname:8s} kernel {t['kernel']:.4f} ms  "
                f"plain {t['plain']:.4f} ms  library {t['library']:.4f} ms  "
                f"bound {t['bound']:.4f} ms ({t['by']})  "
                f"[{rows[name][dname]['shape']}]")
    return rows, out


# ---------------------------------------------------------------------------
# phase 3: the serving path at full width
# ---------------------------------------------------------------------------

ARCH = "llama32-3b"
LOGIT_MATCH_FLOOR = 0.90      # teacher-forced top-1 match, kernel vs plain
LOGIT_DRIFT_CEILING = 0.5     # max |logit difference|, kernel vs plain
# bf16: the plain path rounds the scores and the probabilities to bf16
# (as the JAX package does) where the kernels keep them in f32, and the
# difference compounds over 28 layers; logits have unit scale here.


class FiniteLogits:
    """Wraps a Model's head so every logit row it produces is checked for
    finiteness (one reduction per call, read once at the end)."""

    def __init__(self, model):
        self.flags = []
        head = model._head

        def checked(params, x):
            out = head(params, x)
            self.flags.append(torch.isfinite(out).all())
            return out
        model._head = checked
        self.model, self.head = model, head

    def assert_all(self, what: str):
        ok = bool(torch.stack(self.flags).all()) if self.flags else False
        self.model._head = self.head
        if not ok:
            raise AssertionError(f"{what}: non-finite logits")
        return len(self.flags)


def expect_launches(what, counts, L, passes, flash, decode, paged):
    """The launches of one run: (2L+1) norms per forward pass, one B2 per
    layer of every prefill pass, one B3/B4 per layer of every decode step."""
    want = {"rmsnorm": (2 * L + 1) * passes, "flash_attention": L * flash,
            "decode_attention": L * decode, "paged_decode_attention": L * paged}
    log(f"  launches {what}: {counts}")
    if counts != want:
        raise AssertionError(f"{what}: launches {counts} != expected {want}")


def serving_phase(dev, smi):
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime.backends import make_backend
    from repro_torch.runtime.engine import InferenceEngine
    from repro_torch.runtime.request import make_poisson_trace
    from repro_torch.runtime.scheduler import Scheduler

    cfg = get_config(ARCH)
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = get_model(cfg).init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["blocks"].values()) + sum(
        params[k].numel() for k in ("embed", "lm_head", "final_norm"))
    log(f"[model] {ARCH} full width: L={L} d={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} vocab={cfg.vocab_size} "
        f"{cfg.dtype}, {n_params / 1e9:.3f} B parameters, init "
        f"{time.perf_counter() - t0:.1f} s")
    totals = {name: 0 for name in _build.LAUNCHES}
    finite = FiniteLogits(get_model(cfg))

    # (a) the engine: 2 prompts x 128 tokens, 32 new tokens each
    prompts = torch.randint(2, cfg.vocab_size, (2, 128),
                            generator=torch.Generator().manual_seed(1))
    _build.reset_launches()
    t0 = time.perf_counter()
    out = InferenceEngine(cfg, params, max_len=1024, decode_chunk=8,
                          device=dev).generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    if tuple(out.shape) != (2, 32) or int(out.min()) < 0 or \
            int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"engine output {tuple(out.shape)} out of range")
    log(f"[engine] generate 2x128 -> 2x32 tokens in {wall:.3f} s ({smi})")
    expect_launches("engine", counts, L, passes=32, flash=1, decode=31,
                    paged=0)
    for k in totals:
        totals[k] += counts[k]

    # (b) contiguous and (c) paged + chunked Scheduler over one trace
    reports = {}
    for mode, kw, chunk in (("contiguous", {}, None),
                            ("paged", dict(paged=True, page_size=16), 256)):
        trace = make_poisson_trace(8, rate=0, vocab_size=cfg.vocab_size,
                                   prompt_lens=(64, 512),
                                   decode_lens=(16, 64), seed=0, quantum=32)
        backend = make_backend("gspmd", cfg, params, num_slots=4,
                               max_len=1024, device=dev, **kw)
        _build.reset_launches()
        report = Scheduler(backend, chunk_size=chunk).run(trace)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        for req, m in zip(trace, report.metrics):
            if m.num_generated != req.max_new_tokens or \
                    m.finish_reason != "length":
                raise AssertionError(
                    f"{mode}: request {m.rid} produced {m.num_generated} of "
                    f"{req.max_new_tokens} tokens ({m.finish_reason})")
        n_dec = sum(1 for r in report.steps if r.phase == "decode")
        n_chunks = sum(1 for r in report.steps if r.phase == "prefill")
        log(f"[serve {mode}] {len(report.metrics)} requests, "
            f"{report.total_tokens} tokens, {n_dec} decode steps, "
            f"{n_chunks} prefill chunks ({smi})")
        log(f"[serve {mode}] summary {json.dumps(report.summary())}")
        if chunk:
            expect_launches(mode, counts, L, passes=n_chunks + n_dec,
                            flash=n_chunks, decode=0, paged=n_dec)
        else:
            expect_launches(mode, counts, L, passes=len(trace) + n_dec,
                            flash=len(trace), decode=n_dec, paged=0)
        for k in totals:
            totals[k] += counts[k]
        reports[mode] = report.tokens_by_rid()
        del backend
    n = finite.assert_all("serving phase")
    log(f"[serve] {n} logit batches, all finite")
    same = sum(reports["contiguous"][r] == reports["paged"][r]
               for r in reports["paged"])
    log(f"[serve] paged streams equal to contiguous: {same}/8 (bf16)")
    decode_breakdown(dev, params, smi)
    return params, totals


def decode_breakdown(dev, params, smi, steps: int = 8):
    """Where one decode step's time goes at 4 slots: host wall per step
    (synchronised, no profiler), and the device's busy time per step from
    torch.profiler's kernel records; idle share = 1 - busy / wall."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import get_model

    cfg = get_config(ARCH)
    model = get_model(cfg)
    prompts = torch.randint(2, cfg.vocab_size, (4, 128), device=dev,
                            generator=torch.Generator(dev).manual_seed(5))

    def run(n, cache, tok, pos):
        for i in range(n):
            logits, cache = model.decode_step(params, cache, tok, pos + i)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return cache, tok

    with torch.inference_mode():
        logits, cache, _ = model.prefill(params, prompts, 1024)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        cache, tok = run(2, cache, tok, 128)                 # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, tok = run(steps, cache, tok, 130)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cache, tok = run(steps, cache, tok, 130 + steps)
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        log(f"[decode step] 4 slots: host wall {wall_ms:.3f} ms/step; "
            "device busy: not measured (profiler recorded no device time)")
        return
    busy_ms = busy_us / 1e3 / steps
    log(f"[decode step] 4 slots at pos ~130: host wall {wall_ms:.3f} ms/step "
        f"(no profiler), device busy {busy_ms:.3f} ms/step (profiler), "
        f"device idle share {1 - busy_ms / wall_ms:.3f} ({smi})")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"    device {e.self_device_time_total / 1e3 / steps:8.3f} "
            f"ms/step {e.count // steps:5d}/step  {e.key[:90]}")
    host = sorted((e for e in prof.key_averages() if e not in events),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    for e in host:
        log(f"    host   {e.self_cpu_time_total / 1e3 / steps:8.3f} "
            f"ms/step {e.count // steps:5d}/step  {e.key[:90]}")


# ---------------------------------------------------------------------------
# phase 4: the kernel path against the plain path on the whole model
# ---------------------------------------------------------------------------


def model_compare_phase(dev, params):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime.engine import InferenceEngine

    cfg = get_config(ARCH)
    prompt = torch.randint(2, cfg.vocab_size, (1, 256),
                           generator=torch.Generator().manual_seed(2)).to(dev)
    split = 128

    def teacher_forced(model, paged: bool):
        """Next-token logits at positions split-1 .. 255: a prefill (or a
        paged chunk) of the first ``split`` tokens, then one decode step per
        remaining prompt token."""
        rows = []
        with torch.inference_mode():
            if paged:
                ps = 16
                cache = model.init_paged_cache(1 + 256 // ps, ps, dev)
                bt = torch.arange(1, 1 + 256 // ps, device=dev,
                                  dtype=torch.int32)[None]
                pos = torch.zeros(1, dtype=torch.int32, device=dev)
                logits, cache = model.paged_step(params, cache,
                                                 prompt[:, :split], pos, bt)
            else:
                logits, cache, _ = model.prefill(params, prompt[:, :split],
                                                 256)
            rows.append(logits)
            for i in range(split, 256):
                if paged:
                    pos = torch.full((1,), i, dtype=torch.int32, device=dev)
                    logits, cache = model.paged_step(params, cache,
                                                     prompt[:, i:i + 1], pos,
                                                     bt)
                else:
                    logits, cache = model.decode_step(params, cache,
                                                      prompt[:, i], i)
                rows.append(logits)
        return torch.cat(rows).float()

    ref = teacher_forced(get_model(cfg, plain=True), paged=False)
    for paged in (False, True):
        got = teacher_forced(get_model(cfg), paged)
        match = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
        drift = float((got - ref).abs().max())
        what = "paged (B2 chunk + B4)" if paged else "contiguous (B2 + B3)"
        log(f"[compare bf16] {what} vs plain, {ref.shape[0]} teacher-forced "
            f"positions: top-1 match {match:.4f} (floor "
            f"{LOGIT_MATCH_FLOOR}), max logit drift {drift:.4f} (ceiling "
            f"{LOGIT_DRIFT_CEILING})")
        if not (match >= LOGIT_MATCH_FLOOR and drift <= LOGIT_DRIFT_CEILING
                and torch.isfinite(got).all()):
            raise AssertionError(f"bf16 {what}: kernel path drifted from "
                                 "the plain path")
    del params

    # f32 at reduced depth: greedy tokens identical
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    p32 = get_model(cfg32).init(seed=3, device=dev)
    prompts = torch.randint(2, cfg.vocab_size, (2, 128),
                            generator=torch.Generator().manual_seed(4))
    a = InferenceEngine(cfg32, p32, max_len=256, device=dev).generate(
        prompts, max_new_tokens=32)
    b = InferenceEngine(cfg32, p32, max_len=256, device=dev,
                        plain=True).generate(prompts, max_new_tokens=32)
    same = bool(torch.equal(a, b))
    log(f"[compare f32] L=4 full width, greedy 2x32 tokens kernel path == "
        f"plain path: {same}")
    if not same:
        raise AssertionError("f32 greedy tokens differ between the kernel "
                             "and the plain path")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


REPLACES = {
    "rmsnorm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/rmsnorm_kernel.py:25"),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_kernel.py:80"),
    "decode_attention": (
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_kernel.py:56"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/paged_kernel.py:70"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (no model runs, no ok line)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's per-kernel register/spill report")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    smi = nvidia_smi_line()
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build(verbose=args.ptxas)
    _build.lib()
    log(f"[build] libkernels.so in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.last_build_seconds} s)")

    rows, times = kernel_phase(dev, args.iters)
    if args.kernels_only:
        return 0
    params, launches = serving_phase(dev, smi)
    model_compare_phase(dev, params)
    del params

    table = []
    for name, (source, replaces) in REPLACES.items():
        t = times[name]["bfloat16"]
        table.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(rows[name][d]["err"] for d in rows[name]),
            ms=t["kernel"], kernel_ms=t["kernel"], plain_ms=t["plain"],
            bound_ms=t["bound"], bound_by=t["by"], library_ms=t["library"],
            shape=rows[name]["bfloat16"]["shape"], dtype="bfloat16"))
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
