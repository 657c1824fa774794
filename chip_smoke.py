#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py            # every phase, one card

Phases:
  1. the card's name and power limit, and the kernels' build time;
  2. each hand-written kernel (B1 RMSNorm, and B1 with the residual add
     fused in, add_rms_norm, and on the int8/fp8 wire also the dequantize,
     dequantize_add_rms_norm; B2 flash prefill, B3 contiguous and B4 paged
     flash-decode, B5, B6, B9 the quantized all-reduce's amax, quantize and
     dequantize — B6 from the scales and from the all-reduced abs-max, its
     written scales against scales_from_amax —, the int4 wire's three fused
     passes that hold B7 nibble pack and B8 unpack, B10 the RWKV-6 WKV
     recurrence) against its plain PyTorch version at the main paths'
     shapes, in bf16 and f32 — B1–B4 and B10 within the tolerance stated,
     the quantization kernels and the fused norms' s bit for bit; times of
     the kernel, the plain version and one library call computing the same
     function (where one exists), beside the card's bound for the work (and
     the launch floor for the norms and the quantization kernels, an empty
     kernel at B5's and B6's grids; for the fused norms and B6 from the
     abs-max also the chain they replace);
  3. the serving path at the full width of llama32-3b (random weights from
     a seed, made on the card): InferenceEngine.generate, the contiguous
     Scheduler and the paged Scheduler with chunked prefill, one decode
     step's time breakdown and one 333-token prefill pass's (B2's share),
     and (d) the serve launcher as a user runs it (``launch.serve.main``:
     4 prompts of 32 tokens, 16 new), its first sequence equal to the
     engine's on the same seed's weights and prompts; phases 4-9 and 12
     run llama32-3b at full width on the first LLAMA_DEPTH (8) of its 28
     layers, phase 3's weights cut, to keep the run inside its limit;
  4. the kernel path against the plain path on the whole model, beside a
     yardstick: the plain path with f64 attention against the plain path;
  5. the explicit tensor-parallel engine at t = 4 virtual ranks, full
     width: (a) the comm log of a prefill and a decode step equals
     commodel.comm_ops_for in every quant mode (and unquantized at t = 2),
     (b) TPBackend (contiguous int8, paged unquantized) serves the trace,
     (c) TP against the single-device path and each quant mode against
     unquantized TP on the whole model (QUANT_TOLERANCE, or the limits
     FULL_WIDTH_QUANT_LIMITS sets beside a measured miss), f32 greedy
     tokens at L = 4,
     (d) quantized_psum with kernels == with plain versions, bit for bit
     (run before (c)),
     (e) every run's launches equal their formula; (f) TPModel at t = 1
     on a DistGroup of one NCCL rank bit for bit the virtual t = 1 run
     (the real-rank engines' NCCL start-up; ``rank_launches`` is the
     per-rank formula tests/test_torch_dist_cuda.py holds four cards to);
     one TP decode step's time breakdown (unquantized, int8 and int4);
  6. the RWKV-6 path at the full width of rwkv6-7b (random weights from a
     seed, made on the card after llama32-3b's are freed): (a) the engine,
     (b) the contiguous Scheduler over the trace, every logit finite,
     (c) launches equal their formula (B1 2L+1 and B10 L per pass, no
     B2–B9), (d) the kernel path against the plain path on the whole
     model (bf16 teacher-forced; f32 greedy tokens at L = 4), (e) one
     decode step's time breakdown, (f) one 512-token prefill pass's, with
     B10's chunked kernel and with its per-step kernel;
  7. the pipeline and hybrid engines on virtual stages, full width of
     llama32-3b, (t, p) = (1, 4) and (2, 2): (a) PipelineEngine
     prefill + generate on 4 prompts of the trace, tokens and logits
     bitwise the single-stage path's (Model, TPModel t = 2); (b) its
     transfers equal the send rows of commodel.pp_comm_ops /
     hybrid_comm_ops and each stage's comm log
     hybrid_stage_collectives; (c) PPBackend through the Scheduler over
     the trace's first 5 requests ((1, 4) contiguous at inflight 1 and 4, (2, 2) paged at
     inflight 2, (2, 2) contiguous int8), every logit finite, the
     schedule clock of a one-wave trace equal to pp_schedule_stats, f32
     streams at L = 4 equal across depths and to the single device;
     (d) every run's launches equal their formula (the standalone B9
     at each boundary of a quantized step); (e) one decode round's time
     breakdown per layout, with the boundary hops' device time;
  8. context parallelism on virtual CP workers, full width of llama32-3b,
     (t, c, p) = (1, 2, 1), (2, 2, 1), (1, 2, 2) and, in (b)-(d),
     (2, 2, 2) (TP x CP x PP, held to TPModel t = 2): (a) in phase 2, B2
     at the CP shard shapes (a 333-token prompt padded to 334 at c = 2:
     offsets 0 and 167, t = 1 and 2, a window of 64 at offset 167) and
     its time beside SDPA with a boolean [S/c, S] mask; (b) CP prefill +
     16 greedy tokens on phase 7's prompts against the c = 1 path (Model,
     TPModel t = 2), every ring-assembled K/V bitwise its shards' blocks,
     bf16 teacher-forced within the kernel-path limits, f32 greedy tokens
     identical at L = 4 on padded prompts; (c) the comm logs equal
     comm_ops_for(c=) (cp_comm_ops at t = 1), every stage's log
     hybrid_stage_collectives(c=2) and the transfers the send rows;
     (d) the launch formulas (L·t·c B2 a CP pass, c + 1 B1) and no
     plain attention on the card; (e) the three CP backends through the
     Scheduler over the trace's first 5 requests ((2, 2) paged), streams against the c = 1
     backend's, tokens/s; (f) one 2048-token prefill at t = 1, c = 1, 2,
     4: host wall, device busy, B2 and the ring copies beside
     slo.predict_slo's TTFT;
  9. failure semantics, the prefix cache and disaggregated pools, full
     width of llama32-3b: (a) a template trace (2 templates of 256
     tokens, one prompt a template alone) on the paged Scheduler with the
     prefix cache off and on: hits page-aligned (or capped one short),
     copy-on-writes replayed, no page leaked, launches (a warm chunk L
     B2, a one-token suffix L B4), warm streams against cold, and the
     trace's prefill work cold and warm (host wall, device busy);
     (b) f32 at L = 4: optimistic admission on an oversubscribed pool
     (gspmd, TP t = 2) preempts, streams equal a conservative run's,
     recompute rows equal preemption_recompute_ops; scripted transient
     faults at every site (PP (1, 2)) retried, streams the fault-free
     ones; a deadline and a cancel; (c) (b)'s trace in bf16 at full
     depth: the share of recompute tokens equal to the stream's
     (measured); (d) DisaggScheduler on gspmd and TP t = 2 pools sharing
     one KVPool: handoff bytes equal kv_handoff_ops, export/import ms per
     page and GB/s beside predict_slo's handoff term, the bf16
     cross-pool first-token agreement (measured), f32 at L = 4 end to
     end with the cross-pool identity check, streams against colocated;
 10. the moe and hybrid families at full width, after phase 6 (each model
     freed before the next; peak device memory logged per model):
     deepseek-moe-16b (28 layers, 64 routed experts top-6 and 2 shared)
     and hymba-1.5b (32 layers, attention heads beside selective-SSM
     heads, a window of 1024), bf16 from seed 0: (a) the engine, greedy
     tokens equal at decode_chunk 1 and 8; (b) the contiguous Scheduler at
     4 slots over the trace's first 5 requests (a slot refilled while the
     others decode; hymba: two more prompts of 1100 and 1500 tokens, past
     the window) against solo batch-1 engine runs, streams equal, the MoE
     pairs each prefill drops logged and none dropped in decode; every
     run's launches equal their formula (hymba: 2L more B1, its branch
     norms); (c) the kernel path against the plain path, teacher-forced,
     beside the yardstick (f64 attention), with the routing decisions
     whose expert set differs counted; (d) a decode step's breakdown
     (deepseek: the MoE FFN's device ms beside the step's bytes bound;
     hymba also a 256-token prefill with the selective scan's share of
     host wall and device busy); (e) f32, deepseek at L = 4 and hymba at
     full depth: greedy tokens kernel path == plain, hymba's on prompts
     that cross its window during decode and past it at prefill; (f)
     before the models, B2 and B3 at both models' head shapes against
     their plain versions, bf16 and f32, hymba's windowed prompts and
     wrapped rings included; (g) deepseek-moe-16b on the expert-TP path
     (``moe_ffn_local`` on virtual (data, model) meshes (1, 2), (1, 4),
     (2, 2), on (a)–(d)'s weights): the comm log of a forward pass and of
     the engine's passes (one model all-reduce of a data shard's [tokens,
     h] a layer; at dp = 2 the aux loss's all-reduce over data where the
     pass keeps it), the dense launch formula, bf16 teacher-forced at
     (1, 4) against the GSPMD path (routing flips counted; the floor or
     the yardstick), a decode step's breakdown with the ``moe.ffn``
     range, and in (e) f32 greedy tokens at (1, 2) and (1, 4) equal to
     the GSPMD path's;
 11. the encoder and vlm families at full width, after phase 10:
     (a) beside phase 2, B2 in the bidirectional mask at hubert-xlarge's
     q[2,1000,16,80] (and at a ragged KV length) and in the prefix mask at
     paligemma-3b's q[1,256+64,8,256] over one KV head (and with a window
     and a prefix off the 64-key grid), B3 at q[4,8,256] on the 1024-row
     ring and B4 at D 256, against their plain versions in bf16 and f32,
     each model's B2 and B3 timed beside its bound and SDPA;
     (b) hubert-xlarge (48 layers, D 80), bf16 from seed 0: encode two
     1000-frame clips and one of 1500 (L B2 a pass, no B3 or B4), the
     per-frame argmax and max drift against the plain path beside the
     yardstick, one pass's breakdown, f32 at L = 4 within 1e-4;
     (c) paligemma-3b (18 layers, 8 query heads over 1 KV head at D 256)
     with 256 image-prefix embeddings: generate on prompts of 16 and 64
     text tokens, decode_chunk 1 == 8; teacher-forced kernel vs plain
     beside the yardstick; its text requests through the contiguous
     Scheduler against solo runs; f32 at L = 4, greedy tokens kernel ==
     plain; (d) peak device memory and one prefill pass's breakdown per
     model; every run's launches equal their formula;
 12. training at the full width of llama32-3b, after phase 9 on its
     params (which (c) trains in place): (a) f32 at L = 4, B = 2, S =
     512: make_loss_fn's gradient on the kernel path (B1, add_rms_norm,
     B2 forward; each backward the plain version's gradient) against the
     plain path's, remat "full" and "dots" against none, the fused loss
     against the dense one, every leaf within GRAD_BOUND of its largest
     value; (b) bf16 at LLAMA_DEPTH: the loss and each leaf's cosine and
     relative norm error against the plain path, beside the yardstick;
     (c) 8 AdamW steps on one batch, the loss falling, every value
     finite; (d) every pass's launches equal their formula, none in the
     backward (remat: the recomputed layers' again); (e) one step's
     breakdown: host wall, device busy, idle share, the train.fwd / bwd /
     opt ranges' device ms, B2's forward beside its backward, tokens/s,
     peak memory; (f) params and AdamW state (L = 4 f32) saved and loaded
     back bitwise, the resumed step bitwise the continued one; (g)
     rwkv6-7b (B10), deepseek-moe-16b, hymba-1.5b (B2 windowed),
     hubert-xlarge and paligemma-3b at L = 2 f32, kernel vs plain
     gradients as (a);
 13. the roofline of the steps whose device busy phases 3, 10 and 12
     measured (llama32-3b's decode step at 4 slots and 333-token
     prefill, deepseek-moe-16b's decode step, llama32-3b's train step):
     ``core.op_cost``'s FLOPs, compulsory HBM traffic and eager-traffic
     estimate of each, walked on meta tensors, through
     ``core.roofline.analyze`` (on the compulsory traffic) with H100_NODE
     and with the card's own constants, beside the busy over the lower
     bound and over the eager estimate's memory time;
 14. the sharded (GSPMD-style) step on a ``DeviceMesh`` (A13 part 2):
     (a) ``launch.dryrun.run_one`` at full width on meta tensors over a
     fake process group of 256 ranks, granite-8b prefill_32k and
     internlm2-1.8b decode_32k on (data, model) = (16, 16) (8 KV heads on
     16: K/V gathered, and the sequence-parallel decode), deepseek-moe-16b
     decode_32k (the experts on the expert axis, their counts gathered
     over "data"), the same on the local dispatch (``moe_local``: each
     data shard routes its own tokens, the stacks redistributed from E to
     f by three all-to-alls a layer), mixtral-8x22b prefill_32k
     ``moe_local_fsdp`` (stacks on f, gathered over "data" three a
     layer), rwkv6-7b prefill_32k (the time mix and the channel
     mix's reduce-scatter and all-gather) and hymba-1.5b decode_32k (10
     attention heads over 5 KV heads on 16: the sequence-parallel decode
     on its 1024-row ring, the mamba branch's gathered xz), each record's
     collectives equal to ``step_comm.closed_form``, its seconds and its
     roofline row printed; (b) on the card, an NCCL group of one rank (a ``HashStore``,
     no network) and a (1, 1) ``DeviceMesh``: llama32-3b at full width in
     bf16 from seed 0, the 333-token prefill and 16 decode steps through
     the sharded ``make_serve_step`` (DTensor parameters and cache, the
     kernels under ``local_map``), logits and tokens bitwise equal to the
     unsharded kernel path and its tokens to ``InferenceEngine``'s, the
     launches of both runs equal to their formula, and the collectives
     ``core.step_comm`` reads off the sharded run only over groups of one
     device (each named); (c) B3's split pass alone, which the
     sequence-parallel decode runs on each rank's rows of the cache, at
     (a)'s internlm2-1.8b shard (8 sequences, 2048 rows, 8 KV heads, 16
     query heads, D 128) in bf16 and f32: the live splits' f32 partials
     against ``split_partials`` (f32 tolerance), ranks' lengths 0 to 2048;
     (d) as (b), the moe, ssm and hybrid families at full width in bf16
     from seed 0 (rwkv6-7b, deepseek-moe-16b, hymba-1.5b, one after
     another), 2 prompts of 64 tokens prefilled and 8 decode steps through
     the sharded ``make_serve_step``: logits and tokens bitwise equal to
     the unsharded kernel path, the launches of both runs the unsharded
     formula (ssm L B10 a pass, moe the dense counts, hybrid 2L more B1),
     and no collective over more than one device; deepseek-moe-16b once
     more on the local dispatch (``moe_dispatch="local"``, the same
     parameters), held the same way;
 15. the repo's entry points on the card (``repro_torch.examples``): the
     ``run`` of serve_demo (the contiguous Scheduler over a Poisson trace
     at 4 req/s, its TTFT and TPOT printed beside ``predict_slo``),
     comm_study's ``--measure`` (``PipelineEngine`` at (t, p) = (1, 2),
     its transfers equal to ``pp_comm_ops`` at b = 2), quant_demo (TP t =
     2 int8 teacher-forced against unquantized, held to QUANT_TOLERANCE,
     each decode's logged collectives to the closed form, its tokens/s
     and wire bytes printed) and quickstart (forward, one AdamW step,
     generate) at the full width of llama32-3b on LLAMA_DEPTH layers in
     bf16 from seed 0; then prefix_demo, chaos_demo and disagg_demo,
     whose invariant is a token stream identical to a solo or fault-free
     run, in f32 on as many layers (phase 9 holds those identities in
     f32); each example's invariants held, each of the kernels it
     reaches launched; then
     ``repro_torch.paper.run`` on the card's host, every Fig. 4 row
     EXACT;
 16. one JSON line with the kernel table, then the ok line.

It imports nothing of JAX, exits non-zero with no ok line when there is no
card or when it is not inside a checkout of the repository, and lets every
phase's error end the run.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
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
    # B10 over up to 512 sequential steps (y and the final state): nvcc
    # contracts the f32 state update to an FMA, one rounding fewer per step
    # than the plain version, and y sums over i in another order; the
    # difference accumulates at about one f32 ulp of the state per step
    # (512 · 2^-24 ≈ 3e-5 of its scale, here O(10)).  bf16 rounds y once
    # more on each side (2^-8 relative).
    "wkv6 bfloat16": (2e-2, 1e-2),
    "wkv6 float32": (1e-3, 1e-3),
}


# phases 4-9 and 12 run llama32-3b at full width on the first LLAMA_DEPTH
# of its 28 layers (phase 3's weights, cut): a cut of depth, not of any
# check, that keeps the whole run near half of its 1200 s limit
LLAMA_DEPTH = 8
# the steps of the roofline phase (13), and what the breakdowns of phases
# 3, 10 and 12 measured of them: {step: (host wall ms, device busy ms)}
ROOFLINE_STEPS = ("llama32-3b decode, 4 slots", "llama32-3b prefill, 333",
                  "deepseek-moe-16b decode, 4 slots",
                  f"llama32-3b L={LLAMA_DEPTH} train, B=2 S=512")
MEASURED = {}
T_START = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def progress(line: str) -> None:
    """``line`` logged, and echoed to stderr with the run's seconds so far
    (the end of stderr then names the last phase reached)."""
    log(line)
    print(f"{line} (at {time.perf_counter() - T_START:.1f} s)",
          file=sys.stderr, flush=True)


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


def compare(name, got, want, dtype: str, kind: str = "") -> float:
    """Max abs error of got vs want; raises past the stated tolerance
    (``TOLERANCE[kind + " " + dtype]`` when ``kind`` is given)."""
    atol, rtol = TOLERANCE[f"{kind} {dtype}" if kind else dtype]
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
SPLIT_LENGTHS = (128, 129, 1, 1024)


def kernel_phase(dev, iters: int):
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_cuda, paged_decode_attention_cuda)
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

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
        # -- B2 flash prefill: S in {128, 333}, a window, a paged chunk ---
        cases = [(1, 128, 128, [0], [128], None),
                 (1, 333, 333, [0], [333], None),
                 (2, 333, 333, [0, 0], [333, 333], 100),
                 # a chunk of 256 at pos 300 over the gathered 64-page view
                 (1, 256, 1024, [300], [556], None),
                 # where prefill attention turns operation-bound (timed)
                 (1, 1024, 1024, [0], [1024], None)]
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
            if S == 1024:
                timed["long_args"] = (q, k, v, ints(off), ints(kl))
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
        # split edges (128 rows a split): on an edge, one past it, one key
        lens_s = ints(SPLIT_LENGTHS)
        err = max(err, compare(
            f"B3 decode split edges len={SPLIT_LENGTHS}",
            decode_attention_cuda(q, k, v, lens_s),
            dref.decode_attention_ref(q, k, v, lens_s), dname))
        # a strided slot-subset view of one layer of a [L, 2B, W, Hkv, D]
        # cache, read in place
        big = randn((2, 2 * B, W, Hkv, D), dt)
        kv = big[1, ::2]
        err = max(err, compare(
            "B3 decode strided slot-subset view",
            decode_attention_cuda(q, kv, kv, lens),
            dref.decode_attention_ref(q, kv, kv, lens), dname))
        del big, kv
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
        # split boundaries (128 keys a split at ps 16): on an edge, one
        # past it, one key, beside the 1024-token row, so the short rows'
        # later splits are empty
        lens_s = ints(SPLIT_LENGTHS)
        err = max(err, compare(
            f"B4 paged split edges len={SPLIT_LENGTHS}",
            paged_decode_attention_cuda(q, kp, vp, bt, lens_s),
            dref.paged_decode_attention_ref(q, kp, vp, bt, lens_s), dname))
        rows.setdefault("paged_decode_attention", {})[dname] = dict(
            err=err, args=(q, kp, vp, bt, lens),
            shape=f"q[{B},{Hq},{D}] pages[{P},{ps},{Hkv},{D}] bt[{B},{n}]")
        torch.cuda.synchronize()

    # -- timing, in bf16 (the main path's type) and f32 ------------------
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).replace("torch.", "")
        esz = torch.empty((), dtype=dt).element_size()
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
        if dname == "bfloat16":
            flash_long(r["long_args"], iters)
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


def flash_long(args, iters: int):
    """Log B2 bf16 beside SDPA at one 1024-token prompt, in TFLOP/s, where
    causal prefill attention turns operation-bound (log only: the kernel
    table keeps the S = 333 row)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    q, k, v, off, kl = args
    B, S, Hq, D = q.shape
    flops = 4.0 * D * Hq * B * S * (S + 1) // 2
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    sets = copies((q, k, v, off, kl), nbytes)
    lib_sets = [tuple(a.transpose(1, 2).contiguous() for a in s[:3])
                for s in sets]
    tk = bench(flash_attention_cuda, sets, iters)
    tl = bench(lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, is_causal=True, enable_gqa=True), lib_sets, iters)
    bound, by = bound_ms(nbytes, flops, "bfloat16")
    log(f"  time flash_attention S={S}    bfloat16 kernel {tk:.4f} ms "
        f"({flops / tk / 1e9:.1f} TFLOP/s)  library {tl:.4f} ms "
        f"({flops / tl / 1e9:.1f} TFLOP/s)  bound {bound:.4f} ms ({by})  "
        f"[q[{B},{S},{Hq},{D}], causal]")


CP_SHARD = (167, 334)   # (S/c, S): a 333-token prompt at c = 2, padded


def cp_kernel_rows(dev, iters: int, rows, times):
    """Phase 8(a): B2 at the context-parallel shard shapes against its
    plain version, bf16 and f32 — a shard's queries at offsets 0 and S/c
    over the assembled K/V (llama32-3b's heads at t = 1 and at t = 2) and a
    windowed shard at offset S/c — then, at offset S/c and t = 1, its time
    beside its bound and SDPA with an explicit boolean [S/c, S] mask (its
    is_causal cannot place the offset).  Folds the errors into B2's row
    and the times into ``times["flash_attention"][dtype]["cp_shard"]``."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    s, S = CP_SHARD
    D = FULL["D"]
    g = torch.Generator(device=dev).manual_seed(12)
    kv_pos = torch.arange(S, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).replace("torch.", "")
        esz = torch.empty((), dtype=dt).element_size()
        err, timed = 0.0, None
        for Hq, Hkv, off, win in ((24, 8, 0, None), (24, 8, s, None),
                                  (12, 4, s, None), (24, 8, s, 64)):
            q = torch.randn((1, s, Hq, D), generator=g, device=dev).to(dt)
            k = torch.randn((1, S, Hkv, D), generator=g, device=dev).to(dt)
            v = torch.randn((1, S, Hkv, D), generator=g, device=dev).to(dt)
            args = (q, k, v, torch.tensor([off], device=dev,
                                          dtype=torch.int32),
                    torch.tensor([S], device=dev, dtype=torch.int32))
            err = max(err, compare(
                f"B2 CP shard q[1,{s},{Hq},{D}] kv[1,{S},{Hkv},{D}] "
                f"off={off} win={win}",
                flash_attention_cuda(*args, win),
                flash_attention_ref(*args, win), dname))
            if Hq == 24 and off == s and win is None:
                timed = args
        row = rows["flash_attention"][dname]
        row["err"] = max(row["err"], err)
        q, k, v, off, _ = timed
        q_pos = s + torch.arange(s, device=dev)
        mask = kv_pos[None, :] <= q_pos[:, None]               # [S/c, S]
        pairs = int(mask.sum())
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * esz
        sets = copies(timed, nbytes)
        lib_sets = [tuple(a.transpose(1, 2).contiguous() for a in st[:3])
                    + (mask,) for st in sets]
        t = dict(
            kernel=bench(flash_attention_cuda, sets, iters),
            plain=bench(flash_attention_ref, sets, max(3, iters // 10)),
            library=bench(lambda a, b, c, m: F.scaled_dot_product_attention(
                a, b, c, attn_mask=m, enable_gqa=True), lib_sets, iters),
            shape=f"q[1,{s},24,{D}] off {s} kv[1,{S},8,{D}]")
        t["bound"], t["by"] = bound_ms(nbytes, 4.0 * D * 24 * pairs, dname)
        times["flash_attention"][dname]["cp_shard"] = t
        log(f"  time flash_attention CP shard {dname:8s} kernel "
            f"{t['kernel']:.4f} ms  plain {t['plain']:.4f} ms  library "
            f"{t['library']:.4f} ms (SDPA, boolean mask)  bound "
            f"{t['bound']:.4f} ms ({t['by']})  [{t['shape']}]")


# phase 11(a): B2 and B3 at the encoder's and the vlm's shapes.  hubert:
# two 20-second clips (1000 frames at 50 Hz), the second also at a ragged
# KV length; paligemma: 256 image-prefix positions and 64 text tokens
# over its one KV head, a window and a prefix off the tile grid besides;
# B3 (and B4, which shares its template) at D 256 on the 1024-row ring
ENC_VLM_B2 = (  # (what, B, S, Hq, Hkv, D, mode, prefix_len, window, kv_lens)
    ("hubert-xlarge", 2, 1000, 16, 16, 80, "bidirectional", 0, None,
     (1000, 1000)),
    ("hubert-xlarge ragged", 2, 1000, 16, 16, 80, "bidirectional", 0, None,
     (1000, 613)),
    ("paligemma-3b", 1, 320, 8, 1, 256, "prefix", 256, None, (320,)),
    ("prefix 200 window 100", 1, 320, 8, 1, 256, "prefix", 200, 100, (320,)),
    ("prefix 77 window 50 D 80", 2, 333, 16, 16, 80, "prefix", 77, 50,
     (333, 290)),
)


def sdpa_mask(S, T, mode, prefix_len, window, kv_lens, dev):
    """The boolean [B, 1, S, T] mask SDPA takes for one B2 case."""
    from repro_torch.models.layers import make_mask
    m = make_mask(S, T, mode=mode, window=window, prefix_len=prefix_len,
                  device=dev)
    lens = torch.tensor(kv_lens, device=dev)
    return (m[None] & (torch.arange(T, device=dev) < lens[:, None, None])
            )[:, None]


def encoder_vlm_kernel_rows(dev, iters: int, rows, times):
    """Phase 11(a), run beside phase 2: B2 in the bidirectional and prefix
    masks at hubert-xlarge's and paligemma-3b's head shapes (D 80 and 256,
    ENC_VLM_B2), B3 at paligemma's q[4,8,256] on lengths 1/17/300/1024 of
    a 1024-wide ring and B4 on the same rows in pages, against their plain
    versions in bf16 and f32; then each model's B2 and B3 at its main
    shape timed beside its bound and one SDPA call (``is_causal=False``
    for the encoder, a boolean mask for the prefix, the mask at the
    lengths for B3).  Folds the errors into the kernels' rows and the
    times into ``times[name][dtype]["shapes"]``."""
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_cuda, paged_decode_attention_cuda)
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(14)
    i32 = dict(device=dev, dtype=torch.int32)
    log("[encoder/vlm kernels] B2 bidirectional and prefix at D 80 and 256, "
        "B3 and B4 at D 256")
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).replace("torch.", "")
        esz = torch.empty((), dtype=dt).element_size()

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dt)
        err = {"flash_attention": 0.0, "decode_attention": 0.0,
               "paged_decode_attention": 0.0}
        timed = {}
        for what, B, S, Hq, Hkv, D, mode, pl, win, lens in ENC_VLM_B2:
            q, k, v = randn(B, S, Hq, D), randn(B, S, Hkv, D), \
                randn(B, S, Hkv, D)
            args = (q, k, v, torch.zeros(B, **i32), torch.tensor(lens, **i32),
                    win, mode, pl)
            err["flash_attention"] = max(err["flash_attention"], compare(
                f"B2 {what} q[{B},{S},{Hq},{D}] kv {Hkv} {mode}",
                flash_attention_cuda(*args),
                flash_attention_ref(*args[:6], mode=mode, prefix_len=pl),
                dname))
            if what in ("hubert-xlarge", "paligemma-3b"):
                mask = sdpa_mask(S, S, mode, pl, win, lens, dev)
                timed[what] = (args, mask, int(mask.sum()) * Hq,
                               f"q[{B},{S},{Hq},{D}] kv[{B},{S},{Hkv},{D}] "
                               f"{mode}" + (f" {pl}" if pl else ""))
        B, W, Hq, Hkv, D = 4, 1024, 8, 1, 256
        q, k, v = randn(B, Hq, D), randn(B, W, Hkv, D), randn(B, W, Hkv, D)
        lens = torch.tensor(DECODE_LENGTHS, **i32)
        err["decode_attention"] = compare(
            f"B3 paligemma-3b q[{B},{Hq},{D}] kv[{B},{W},{Hkv},{D}]",
            decode_attention_cuda(q, k, v, lens),
            dref.decode_attention_ref(q, k, v, lens), dname)
        b3_args = (q, k, v, lens)
        ps = 16
        pages = torch.arange(1, 1 + B * W // ps, **i32).reshape(B, W // ps)
        kp = torch.cat([torch.zeros_like(k[0, :ps]), k.reshape(-1, Hkv, D)]
                       ).reshape(-1, ps, Hkv, D)
        vp = torch.cat([torch.zeros_like(v[0, :ps]), v.reshape(-1, Hkv, D)]
                       ).reshape(-1, ps, Hkv, D)
        err["paged_decode_attention"] = compare(
            f"B4 D 256 pages[{kp.shape[0]},{ps},{Hkv},{D}]",
            paged_decode_attention_cuda(q, kp, vp, pages, lens),
            dref.paged_decode_attention_ref(q, kp, vp, pages, lens), dname)
        for name, e in err.items():
            rows[name][dname]["err"] = max(rows[name][dname]["err"], e)
        torch.cuda.synchronize()

        # times: each model's B2, paligemma's B3
        out = {}
        for what, (args, mask, pairs, shape) in timed.items():
            aq, ak, av = args[:3]
            nbytes = (2 * aq.numel() + ak.numel() + av.numel()) * esz
            sets = copies(args[:5], nbytes)
            kw = dict(window=args[5], mode=args[6], prefix_len=args[7])
            bidir = args[6] == "bidirectional" and bool(
                args[4].eq(aq.shape[1]).all())
            lib_sets = [tuple(a.transpose(1, 2).contiguous() for a in st[:3])
                        + (None if bidir else mask,) for st in sets]
            t = dict(
                kernel=bench(lambda *a: flash_attention_cuda(*a, **kw), sets,
                             iters),
                plain=bench(lambda *a: flash_attention_ref(*a, **kw), sets,
                            max(3, iters // 10)),
                library=bench(lambda a, b, c, m: F.scaled_dot_product_attention(
                    a, b, c, attn_mask=m, enable_gqa=True), lib_sets, iters),
                shape=shape, library_call="SDPA, is_causal=False" if bidir
                else "SDPA, boolean mask")
            t["bound"], t["by"] = bound_ms(nbytes, 4.0 * aq.shape[-1] * pairs,
                                           dname)
            out[("flash_attention", what)] = t
        args = b3_args
        live = sum(min(x, W) for x in DECODE_LENGTHS)
        nbytes = 2 * q.numel() * esz + 2 * live * Hkv * D * esz
        sets = copies(args, sum(a.numel() * a.element_size() for a in args))
        lib_sets = []
        for a, kk, vv, d in sets:
            m = (torch.arange(W, device=dev)[None, :]
                 < d[:, None])[:, None, None, :]
            lib_sets.append((a[:, :, None].contiguous(),
                             kk.transpose(1, 2).contiguous(),
                             vv.transpose(1, 2).contiguous(), m))
        t = dict(
            kernel=bench(decode_attention_cuda, sets, iters),
            plain=bench(dref.decode_attention_ref, sets,
                        max(3, iters // 10)),
            library=bench(lambda a, b, c, m: F.scaled_dot_product_attention(
                a, b, c, attn_mask=m, enable_gqa=True), lib_sets, iters),
            shape=f"q[{B},{Hq},{D}] kv[{B},{W},{Hkv},{D}]",
            library_call="SDPA, mask at the lengths")
        t["bound"], t["by"] = bound_ms(nbytes, 4.0 * D * Hq * live, dname)
        out[("decode_attention", "paligemma-3b")] = t
        for (name, what), t in out.items():
            times[name][dname].setdefault("shapes", {})[what] = t
            log(f"  time {name} {what:<14s} {dname:8s} kernel "
                f"{t['kernel']:.4f} ms  plain {t['plain']:.4f} ms  library "
                f"{t['library']:.4f} ms ({t['library_call']})  bound "
                f"{t['bound']:.4f} ms ({t['by']})  [{t['shape']}]")

NORM_ROWS = (4, 333)    # a decode step's 4 slots, a 333-token prefill
# the rows of each kernel's line in the kernel table: B1's and the add's
# prefill shape; the dequantize variant runs only in decode steps
NORM_TABLE_ROWS = {"rmsnorm": 333, "add_rms_norm": 333,
                   "dequantize_add_rms_norm": 4}


def norm_kernel_phase(dev, iters: int):
    """B1, add_rms_norm (B1 with the residual add before it) and
    dequantize_add_rms_norm (B9, the add and B1, int8 and fp8) against
    their plain versions: s bit for bit, n within the tolerance, and n bit
    for bit B1's of s (one reduction tree in the three kernels); at
    llama32-3b's h (3072), rwkv6-7b's (4096), hubert-xlarge's (1280: 160
    or 320 16-byte vectors over 128 threads, spread unevenly) and
    paligemma-3b's (2048, at a decode step's rows and a prefill's) on the
    16-byte path, an odd h and a row view off a 16-byte boundary on the
    element path, the
    last position of each prefill sequence (a row-strided view), in bf16
    and f32.  Times in bf16 at 4 and 333 rows of 3072, each beside its
    bound, the launch floor, the unfused chain it replaces (x + y then B1;
    B9, the add, B1) and, for B1, ``F.rms_norm``."""
    from repro_torch.kernels.quant_collective import ops as qops
    from repro_torch.kernels.quant_collective import ref as qref
    from repro_torch.kernels.rmsnorm.ops import (add_rms_norm_cuda,
                                                 rms_norm_cuda)
    from repro_torch.kernels.rmsnorm.ref import add_rms_norm_ref, rms_norm_ref

    g = torch.Generator(device=dev).manual_seed(17)
    rows, errs = {}, {}

    def randn(shape, dt, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dt)

    def wire(x, chunk, quant):
        """x's int8/fp8 payload and scales, as quantized_psum makes them."""
        scales = qops.scales_from_amax(qops.chunk_amax_cuda(x, chunk),
                                       qops.collective_qmax(quant, TP))
        return (qops.chunk_quantize_cuda(x, scales, chunk,
                                         qops.QUANT_DTYPES[quant]), scales)

    def check(name, what, got, want, n_of_s, dname):
        """s bitwise; n within the tolerance and bitwise B1's of s."""
        bitwise(f"{name} s {what}", got[0], want[0])
        errs[name] = max(errs.get(name, 0.0), compare(
            f"{name} n {what}", got[1], want[1], dname))
        bitwise(f"{name} n == B1(s) {what}", got[1], n_of_s)

    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).replace("torch.", "")
        log(f"[kernels] B1, add_rms_norm, dequantize_add_rms_norm {dname}")
        # (rows, h, chunk, a view off a 16-byte boundary)
        for nrow, h, chunk, shifted in ((4, 3072, 128, False),
                                        (333, 3072, 128, False),
                                        (4, 4096, 128, False),
                                        (4, 1280, 128, False),
                                        (333, 1280, 128, False),
                                        (4, 2048, 128, False),
                                        (320, 2048, 128, False),
                                        (3, 201, 25, False),
                                        (5, 200, 25, False),
                                        (4, 3072, 128, True)):
            what = f"x[{nrow},{h}]" + (" (off 16 bytes)" if shifted else "")
            x, y = randn((nrow, h), dt), randn((nrow, h), dt)
            if shifted:
                x = randn((nrow * h + 1,), dt)[1:].view(nrow, h)
            w = randn((h,), dt, 0.1)
            errs["rmsnorm"] = max(errs.get("rmsnorm", 0.0), compare(
                f"B1 rmsnorm {what}", rms_norm_cuda(x, w),
                rms_norm_ref(x, w), dname))
            got = add_rms_norm_cuda(x, y, w)
            check("add_rms_norm", what, got, add_rms_norm_ref(x, y, w),
                  rms_norm_cuda(got[0], w), dname)
            for quant in ("int8", "fp8"):
                q, scales = wire(y.contiguous(), chunk, quant)
                xd = x.contiguous()
                got = qops.dequantize_add_rms_norm_cuda(q, scales, chunk, xd,
                                                        w)
                check("dequantize_add_rms_norm", f"{quant} chunk {chunk} "
                      f"{what}", got, qref.dequantize_add_rms_norm_ref(
                          q, scales, chunk, xd, w),
                      rms_norm_cuda(got[0], w), dname)
        # the final norm of a prefill pass: the last position of each of 2
        # sequences, a row-strided view of [2, 333, h]
        x, y = randn((2, 333, 3072), dt), randn((2, 333, 3072), dt)
        w = randn((3072,), dt, 0.1)
        got = add_rms_norm_cuda(x[:, -1], y[:, -1], w)
        check("add_rms_norm", "last positions of x[2,333,3072]", got,
              add_rms_norm_ref(x[:, -1], y[:, -1], w),
              rms_norm_cuda(got[0], w), dname)
        for name in ("rmsnorm", "add_rms_norm", "dequantize_add_rms_norm"):
            rows.setdefault(name, {})[dname] = dict(err=errs.pop(name))
    torch.cuda.synchronize()

    # -- timing in bf16 (the main path's type) at 4 and 333 rows ------------
    h, chunk, bf16 = 3072, QCHUNK, torch.bfloat16
    floor = bench(lambda: torch.cuda._sleep(0), [()], iters)
    log(f"  time launch floor (torch.cuda._sleep(0))  {floor:.6f} ms")
    out = {}
    for nrow in NORM_ROWS:
        x, y = randn((nrow, h), bf16), randn((nrow, h), bf16)
        w = randn((h,), bf16, 0.1)
        q, scales = wire(y, chunk, "int8")
        n, k = nrow * h, nrow * (-(-h // chunk))
        # name: (kernel, plain, the chain it replaces, args, bytes moved,
        # operations, library call); bytes: each input read once, each
        # output written once; operations: the f32 element-wise work
        specs = {
            "rmsnorm": (
                rms_norm_cuda, rms_norm_ref, None, (x, w), 2 * (2 * n + h),
                4 * n, lambda a, b: F.rms_norm(a, (h,), b, 1e-5)),
            "add_rms_norm": (
                add_rms_norm_cuda, add_rms_norm_ref,
                lambda a, b, c: rms_norm_cuda(a + b, c), (x, y, w),
                2 * (4 * n + h), 5 * n, None),
            "dequantize_add_rms_norm": (
                lambda a, b, c, d: qops.dequantize_add_rms_norm_cuda(
                    a, b, chunk, c, d),
                lambda a, b, c, d: qref.dequantize_add_rms_norm_ref(
                    a, b, chunk, c, d),
                lambda a, b, c, d: rms_norm_cuda(
                    c + qops.chunk_dequantize_cuda(a, b, chunk, bf16), d),
                (q, scales, x, w), n + 4 * k + 2 * (3 * n + h), 7 * n, None),
        }
        for name, (kernel, plain, chain, args, nbytes, ops,
                   library) in specs.items():
            sets = copies(args, nbytes)
            # F.rms_norm scales by w, the kernels by 1 + w
            lib_sets = [(a, 1.0 + b) for a, b in sets] if library else None
            t = dict(kernel=bench(kernel, sets, iters),
                     plain=bench(plain, sets, iters),
                     chain=bench(chain, sets, iters) if chain else None,
                     library=bench(library, lib_sets, iters) if library
                     else None, floor=floor, shape=f"x[{nrow},{h}]")
            t["bound"], t["by"] = bound_ms(nbytes, ops, "float32")
            if nrow == NORM_TABLE_ROWS[name]:
                out.setdefault(name, {})["bfloat16"] = t
                rows[name]["bfloat16"]["shape"] = t["shape"]
            lib = f"{t['library']:.6f} ms" if library else "none (no one call)"
            unfused = f"{t['chain']:.6f} ms" if chain else "—"
            # the same inputs every call, so they stay in the L2: what is
            # left when device memory costs nothing
            warm = bench(kernel, [args], iters)
            log(f"  time {name:<24s} bfloat16 kernel {t['kernel']:.6f} ms  "
                f"unfused chain {unfused}  plain {t['plain']:.4f} ms  library "
                f"{lib}  bound {t['bound']:.6f} ms ({t['by']})  launch floor "
                f"{floor:.6f} ms  L2-warm {warm:.6f} ms  [x[{nrow},{h}]]")
    return rows, out


QDECODE = (4, 3072)     # one rank's rows on the decode path: 4 slots x h
QCHUNK = 128


def bitwise(name, got, want) -> float:
    """Raise unless got and want hold the same bytes; the error is 0."""
    g, w = got.contiguous(), want.contiguous()
    same = (g.dtype == w.dtype and g.shape == w.shape
            and torch.equal(g.view(torch.uint8), w.view(torch.uint8)))
    log(f"  {name:<52s} bitwise {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{name}: kernel and plain version differ")
    return 0.0


def quant_kernel_phase(dev, iters: int):
    """B5, B6 and B9 (int8, fp8) and the int4 wire's three fused kernels
    (chunk_quantize_pack = B6 + B7, nibble_reduce_requant = B8 + exact sum
    + requantize + B7, nibble_unpack_dequantize = B8 + B9) against their
    plain versions, bit for bit, at the decode shape, a ragged h = 160,
    chunk = 64 and an odd chunk (B6's pairs straddle two scales), bf16 and f32 inputs, at t = 4.  B6 and the int4 pre-pass run
    from the scales and from the all-reduced abs-max, as quantized_psum
    runs them (the shared scale computed in the kernel; rank 0's launch
    writes the scales, times t on int4, which are checked against
    scales_from_amax too); the fused int4 kernels on t ranks' rows through
    the comm layer's all-to-all and all-gather.  Times at the decode shape
    in bf16, beside the launch floor, an empty kernel at B5's and B6's
    grids, and the chain the abs-max source replaced (scales_from_amax,
    then B6 from the scales).  B5 and B6 (and the empty kernel) launch by
    programmatic dependent launch, so ``bench``'s back-to-back launches
    overlap each other's tails, as the t launches of each do on the step;
    ``torch.cuda._sleep(0)`` launches as usual.  So B6's and the int4
    pre-pass's rows also time the whole int8 and int4 all-reduce at t
    ranks that they sit in (``allreduce_ms``)."""
    from repro_torch.core import comm
    from repro_torch.kernels.quant_collective import ops as qops
    from repro_torch.kernels.quant_collective import ref as qref

    g = torch.Generator(device=dev).manual_seed(7)
    rows = {}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).replace("torch.", "")
        log(f"[kernels] B5, B6, B9, int4 fused {dname}")
        for shape, chunk in ((QDECODE, QCHUNK), ((3, 160), 64),
                             ((2, 200), 25)):
            xs = [(3 * torch.randn(shape, generator=g, device=dev)).to(dt)
                  for _ in range(TP)]
            x = xs[0]
            where = f"x{list(shape)} chunk {chunk}"
            amax = qops.chunk_amax_cuda(x, chunk)
            bitwise(f"B5 chunk_amax {where}", amax,
                    qref.chunk_amax_ref(x, chunk))
            group = comm.VirtualGroup(TP)
            shared = group.all_reduce([qops.chunk_amax_cuda(a, chunk)
                                       for a in xs], op="max")
            for quant in ("int8", "fp8"):
                qmax = qops.collective_qmax(quant, TP)
                scales = qops.scales_from_amax(amax, qmax)
                qdt = qops.QUANT_DTYPES[quant]
                q = qops.chunk_quantize_cuda(x, scales, chunk, qdt)
                bitwise(f"B6 chunk_quantize {quant} {where}", q,
                        qref.chunk_quantize_ref(x, scales, chunk, qdt))
                q, s = qops.chunk_quantize_shared_cuda(x, shared, qmax, chunk,
                                                       qdt, True)
                want = qref.chunk_quantize_shared_ref(x, shared, qmax, chunk,
                                                      qdt, True)
                bitwise(f"B6 from the abs-max {quant} {where}", q, want[0])
                bitwise(f"B6 its scales == scales_from_amax {quant} {where}",
                        s, qops.scales_from_amax(shared, qmax))
                bitwise(f"B9 chunk_dequantize {quant} {where}",
                        qops.chunk_dequantize_cuda(q, s, chunk, dt),
                        qref.chunk_dequantize_ref(q, s, chunk, dt))
            # the int4 wire on t ranks from the shared abs-max, as
            # quantized_psum runs it: rank 0 writes the scales times t
            qmax = qops.collective_qmax("int4", TP)
            scales = qops.scales_from_amax(shared, qmax)
            bitwise(f"chunk_quantize_pack from the scales {where}",
                    qops.chunk_quantize_pack_cuda(x, scales, chunk),
                    qref.chunk_quantize_pack_ref(x, scales, chunk))
            packed = []
            for r, a in enumerate(xs):
                p, st = qops.chunk_quantize_pack_shared_cuda(
                    a, shared, qmax, chunk, TP, r == 0)
                packed.append(p)
                bitwise(f"chunk_quantize_pack rank {r} {where}", p,
                        qref.chunk_quantize_pack_shared_ref(
                            a, shared, qmax, chunk, TP)[0])
                if r == 0:
                    bitwise(f"chunk_quantize_pack its scales == "
                            f"scales_from_amax * t {where}", st, scales * TP)
                    scales_t = st
            reduced = []
            for r, p in enumerate(group.all_to_all(packed, values_per_item=2)):
                reduced.append(qops.nibble_reduce_requant_cuda(p, TP))
                bitwise(f"nibble_reduce_requant rank {r} {where}",
                        reduced[-1], qref.nibble_reduce_requant_ref(p, TP))
            gathered = group.all_gather(reduced, values_per_item=2)
            bitwise(f"nibble_unpack_dequantize {where}",
                    qops.nibble_unpack_dequantize_cuda(gathered, scales_t,
                                                       chunk, dt),
                    qref.nibble_unpack_dequantize_ref(gathered, scales_t,
                                                      chunk, dt))
        rws, h = QDECODE
        shapes = {
            "chunk_amax": f"x[{rws},{h}] {dname}, chunk {QCHUNK}",
            "chunk_quantize": f"x[{rws},{h}] {dname} + amax[{rws},"
                              f"{h // QCHUNK}] -> int8 + scales, chunk "
                              f"{QCHUNK}",
            "chunk_dequantize": f"q[{rws},{h}] int8 -> {dname}, chunk "
                                f"{QCHUNK}",
            "chunk_quantize_pack": f"x[{rws},{h}] {dname} + amax -> uint8"
                                   f"[{rws},{h // 2}] + scales * t, chunk "
                                   f"{QCHUNK}",
            "nibble_reduce_requant": f"uint8[{rws},{h // 2}] (t={TP} blocks)"
                                     f" -> uint8[{rws},{h // (2 * TP)}]",
            "nibble_unpack_dequantize": f"uint8[{rws},{h // 2}] -> {dname}"
                                        f"[{rws},{h}], chunk {QCHUNK}"}
        for name, shape in shapes.items():
            rows.setdefault(name, {})[dname] = dict(err=0.0, shape=shape)
    torch.cuda.synchronize()

    # -- timing at the decode shape, bf16 input (the main path's type) ------
    rws, h = QDECODE
    n, K = rws * h, -(-h // QCHUNK)
    x = (3 * torch.randn(QDECODE, generator=g, device=dev)).to(torch.bfloat16)
    amax = qops.chunk_amax_cuda(x, QCHUNK)
    q8max, q4max = (qops.collective_qmax(m, TP) for m in ("int8", "int4"))
    s8 = qops.scales_from_amax(amax, q8max)
    s4 = qops.scales_from_amax(amax, q4max)
    q8 = qops.chunk_quantize_cuda(x, s8, QCHUNK, torch.int8)
    packed = qops.chunk_quantize_pack_cuda(x, s4, QCHUNK)
    # one rank's all-to-all row: t source blocks of this rank's packed block
    received = comm.VirtualGroup(TP).all_to_all(
        [qops.chunk_quantize_pack_cuda(
            (3 * torch.randn(QDECODE, generator=g, device=dev)).to(
                torch.bfloat16), s4, QCHUNK) for _ in range(TP)],
        values_per_item=2)[0]
    bf16, kb = torch.bfloat16, 4 * rws * K      # kb: one f32 [rows, K]
    # name: (kernel, plain, args, bytes moved, operations, library call);
    # bytes: each input read once, each output written once; operations:
    # the f32 / integer element-wise work the function needs
    specs = {
        "chunk_amax": (
            lambda a: qops.chunk_amax_cuda(a, QCHUNK),
            lambda a: qref.chunk_amax_ref(a, QCHUNK), (x,),
            2 * n + kb, 2 * n,
            lambda a: torch.linalg.vector_norm(a.view(rws, K, QCHUNK),
                                               ord=float("inf"), dim=-1)),
        # from the abs-max, with the scales write (rank 0's launch):
        # compare, multiply, select per chunk; divide, round, clip per value
        "chunk_quantize": (
            lambda a, m: qops.chunk_quantize_shared_cuda(a, m, q8max, QCHUNK,
                                                         torch.int8, True),
            lambda a, m: qref.chunk_quantize_shared_ref(a, m, q8max, QCHUNK,
                                                        torch.int8, True),
            (x, amax), 2 * n + kb + n + kb, 3 * n + 3 * rws * K, None),
        "chunk_dequantize": (
            lambda q, s: qops.chunk_dequantize_cuda(q, s, QCHUNK, bf16),
            lambda q, s: qref.chunk_dequantize_ref(q, s, QCHUNK, bf16),
            (q8, s8), n + kb + 2 * n, n, None),
        # divide, round, clip per element; mask and shift-or per element;
        # the scale rule and the times t per chunk
        "chunk_quantize_pack": (
            lambda a, m: qops.chunk_quantize_pack_shared_cuda(
                a, m, q4max, QCHUNK, TP, True),
            lambda a, m: qref.chunk_quantize_pack_shared_ref(
                a, m, q4max, QCHUNK, TP, True),
            (x, amax), 2 * n + kb + n // 2 + kb, 5 * n + 4 * rws * K, None),
        # sign-extend and add per received value; divide, round, clip and
        # pack per reduced value
        "nibble_reduce_requant": (
            lambda p: qops.nibble_reduce_requant_cuda(p, TP),
            lambda p: qref.nibble_reduce_requant_ref(p, TP), (received,),
            n // 2 + n // (2 * TP), 2 * n + 5 * n // TP, None),
        # sign-extend and multiply per value
        "nibble_unpack_dequantize": (
            lambda b, s: qops.nibble_unpack_dequantize_cuda(b, s, QCHUNK,
                                                            bf16),
            lambda b, s: qref.nibble_unpack_dequantize_ref(b, s, QCHUNK,
                                                           bf16),
            (packed, s4 * TP), n // 2 + kb + 2 * n, 2 * n, None),
    }
    # the launch floor: the emptiest kernel, torch.cuda._sleep(0), timed
    # as a kernel is; no kernel goes below it, whatever its bytes bound says
    floor = bench(lambda: torch.cuda._sleep(0), [()], iters)
    log(f"  time launch floor (torch.cuda._sleep(0))  {floor:.6f} ms")
    # the grid floor: an empty kernel at B5's and B6's grids
    grid_floor = {}
    for name in ("chunk_amax", "chunk_quantize", "chunk_quantize_pack"):
        grid = qops.quant_grid_cuda(name, x, QCHUNK)
        grid_floor[name] = bench(
            lambda: qops.quant_grid_cuda(name, x, QCHUNK, launch=True), [()],
            iters)
        log(f"  time empty kernel at {name}'s grid {grid} (blocks x, y; "
            f"threads)  {grid_floor[name]:.6f} ms")
    # the chains the abs-max source replaced: scales_from_amax's torch
    # launches, then B6 from the scales (and the times t on int4)
    def unfused_pack(a, m):
        s = qops.scales_from_amax(m, q4max)
        return qops.chunk_quantize_pack_cuda(a, s, QCHUNK), s * TP

    chains = {
        "chunk_quantize": lambda a, m: qops.chunk_quantize_cuda(
            a, qops.scales_from_amax(m, q8max), QCHUNK, torch.int8),
        "chunk_quantize_pack": unfused_pack}
    out = {}
    for name, (kernel, plain, args, nbytes, ops, library) in specs.items():
        sets = copies(args, nbytes)
        t = dict(kernel=bench(kernel, sets, iters),
                 plain=bench(plain, sets, iters),
                 library=bench(library, sets, iters) if library else None,
                 floor=floor)
        if name in grid_floor:
            t["grid_floor"] = grid_floor[name]
        if name in chains:
            t["chain"] = bench(chains[name], sets, iters)
        if name in PDL_KERNELS:
            t["overlapped"] = True
        if name in ALLREDUCE_OF:
            t["allreduce"] = allreduce_ms(dev, ALLREDUCE_OF[name])
        t["bound"], t["by"] = bound_ms(nbytes, ops, "float32")
        out[name] = {"bfloat16": t}
        lib = f"{t['library']:.4f} ms" if library else "none (no one call)"
        more = (f"  unfused chain (scales_from_amax + B6 from the scales) "
                f"{t['chain']:.6f} ms" if "chain" in t else "")
        if "allreduce" in t:
            more += (f"  one {ALLREDUCE_OF[name]} all-reduce at t={TP} "
                     f"(matmuls, B5, max, B6, the hops) {t['allreduce']:.6f}"
                     f" ms")
        if name in PDL_KERNELS:
            more += "  (kernel: back to back, overlapped by PDL)"
        log(f"  time {name:<24s} bfloat16 kernel {t['kernel']:.6f} ms  "
            f"plain {t['plain']:.4f} ms  library {lib}  bound "
            f"{t['bound']:.6f} ms ({t['by']})  launch floor {floor:.6f} ms"
            f"{more}  [{rows[name]['bfloat16']['shape']}]")
    # B6 from the abs-max without the scales write (ranks 1..t-1)
    sets = copies((x, amax), 2 * n + kb + n)
    t = bench(lambda a, m: qops.chunk_quantize_shared_cuda(
        a, m, q8max, QCHUNK, torch.int8), sets, iters)
    out["chunk_quantize"]["bfloat16"]["no_scales_ms"] = t
    log(f"  time chunk_quantize from the abs-max, no scales write  "
        f"{t:.6f} ms")
    return rows, out


# B5 and B6 (and the int4 pre-pass, B6's template) launch by programmatic
# dependent launch: ``bench``'s back-to-back launches of one of them overlap
# each other's tails, so their kernel time is a throughput, not comparable
# with a kernel launched as usual: the time to compare is that of the
# quantized all-reduce they sit in (``allreduce_ms``), on either side
PDL_KERNELS = ("chunk_amax", "chunk_quantize", "chunk_quantize_pack")
ALLREDUCE_OF = {"chunk_quantize": "int8", "chunk_quantize_pack": "int4"}


def allreduce_ms(dev, quant: str, iters: int = 20) -> float:
    """Device ms of one quantized all-reduce at t = TP virtual ranks as the
    TP decode step issues it at 4 slots: each rank's output projection
    (x[4, 768] @ wo[768, 3072], bf16), then ``quantized_psum_gathered``
    (B5 on each rank, the max all-reduce, B6 on each rank, the two hops;
    int4 also its requantize and dequantize).  Only the package's public
    entry points are called, so the same function times any checkout of
    the port on the path.  ``iters`` all-reduces (~25 launches each) stay
    inside the launch queue, so they wait on the device, not the host."""
    from repro_torch.core import comm
    from repro_torch.core.parallel_exec import quantized_psum_gathered

    g = torch.Generator(dev).manual_seed(4)
    acts = [torch.randn(4, 768, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(TP)]
    wos = [(0.02 * torch.randn(768, 3072, generator=g, device=dev)).to(
        torch.bfloat16) for _ in range(TP)]

    def allreduce():
        return quantized_psum_gathered([a @ w for a, w in zip(acts, wos)],
                                       comm.VirtualGroup(TP), quant)

    return bench(allreduce, [()], iters)


# B10 at rwkv6-7b's widths (64 heads of 64): a full-width prefill and a
# decode step at 4 slots, and a ragged shape of the JAX package's sweep
# (hs 32, S not a multiple of 128 — the TPU kernel refuses it, ROADMAP C7)
WKV_SHAPES = {"prefill": (1, 512, 64, 64), "decode": (4, 1, 64, 64),
              "ragged": (2, 200, 3, 32)}
# per-step vs chunked over batch x sequence at rwkv6-7b's heads: where the
# wrapper's pick changes kernel (ops.CHUNK_MIN_S, ops.CHUNK_MAX_BH)
WKV_SWEEP = [(b, s) for b in (1, 2, 4) for s in (1, 8, 16, 32, 64, 128, 512)]


def wkv6_inputs(g, dev, dt, shape, strong=False):
    """r, k, v [B,S,H,hs] ~ 0.5 N(0,1), w ~ U(0.8, 0.999) (the JAX sweep's
    ranges) or, ``strong``, U(0, 0.2) with a quarter exactly 0 (the
    model's bf16 exp(-exp(dw)) rounds to 0), in ``dt``; u [H,hs] f32; a
    non-zero f32 initial state."""
    B, S, H, hs = shape
    r, k, v = ((0.5 * torch.randn(shape, generator=g, device=dev)).to(dt)
               for _ in range(3))
    if strong:
        w = 0.2 * torch.rand(shape, generator=g, device=dev)
        w = torch.where(torch.rand(shape, generator=g, device=dev) < 0.25,
                        0.0, w).to(dt)
    else:
        w = (0.8 + 0.199 * torch.rand(shape, generator=g, device=dev)).to(dt)
    u = 0.3 * torch.randn((H, hs), generator=g, device=dev)
    st = 0.1 * torch.randn((B, H, hs, hs), generator=g, device=dev)
    return r, k, v, w, u, st


def wkv6_kernel_phase(dev, iters: int):
    """B10's two kernels (chunked, per-step) against wkv6_ref (y and the
    final state) at WKV_SHAPES, at S = C-1, C, C+1 and with strong decays
    (exact zeros), in bf16 and f32, from a non-zero state; times of the
    wrapper's pick at the prefill and decode shapes (the prefill row is
    the kernel table's), of each kernel at prefill, and of both kernels
    over WKV_SWEEP (the pick's thresholds)."""
    from repro_torch.kernels.rwkv6_scan.ops import CHUNK, wkv6_cuda
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref

    def kernel(chunk):
        return lambda *a: wkv6_cuda(*a, chunk=chunk)

    full = WKV_SHAPES["prefill"]
    # (label, shape, strong decays, chunks checked; None: the wrapper's pick)
    cases = [(what, shape, False, (None, 0, CHUNK))
             for what, shape in WKV_SHAPES.items()]
    cases += [(f"edge C={CHUNK}", (1, n, 64, 64), False, (CHUNK,))
              for n in (CHUNK - 1, CHUNK, CHUNK + 1)]
    cases += [("strong decays", full, True, (None, 0))]
    g = torch.Generator(device=dev).manual_seed(13)
    rows, out = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).replace("torch.", "")
        log(f"[kernels] B10 {dname}")
        err, timed = 0.0, {}
        for what, shape, strong, chunks in cases:
            args = wkv6_inputs(g, dev, dt, shape, strong)
            want = wkv6_ref(*args)
            for chunk in chunks:
                got = wkv6_cuda(*args, chunk=chunk)
                pick = "pick" if chunk is None else f"C={chunk}" if chunk \
                    else "step"
                for name, a, b in zip(("y", "state"), got, want):
                    err = max(err, compare(
                        f"B10 wkv6 {what} {list(shape)} {pick} {name}", a, b,
                        dname, "wkv6"))
            timed.setdefault(what, args)
        torch.cuda.synchronize()
        B, S, H, hs = full
        rows.setdefault("wkv6", {})[dname] = dict(
            err=err, shape=f"r/k/v/w[{B},{S},{H},{hs}], state[{B},{H},{hs},"
                           f"{hs}] f32")
        esz = torch.empty((), dtype=dt).element_size()

        def timing(args, fn, plain=True):
            B, S, H, hs = args[0].shape
            n = B * S * H * hs
            # r, k, v, w read and y written once; u read; state read, written
            nbytes = 5 * n * esz + 4 * H * hs + 2 * 4 * B * H * hs * hs
            sets = copies(args, nbytes)
            t = dict(kernel=bench(fn, sets, iters),
                     plain=bench(wkv6_ref, sets, max(3, iters // 10))
                     if plain else None, library=None)
            # the f32 operations the function needs: 5 per (b, t, h, i, j)
            # (r·S, an FMA; k·v; w·S + kv, an FMA) and 5 per (b, t, h, j)
            # for the u term, one scalar per step: v_j · sum_i r_i·u_i·k_i
            t["bound"], t["by"] = bound_ms(nbytes, 5.0 * n * hs + 5.0 * n,
                                           "float32")
            return t

        for what in ("prefill", "decode"):
            t = timing(timed[what], wkv6_cuda)
            if what == "prefill":
                out.setdefault("wkv6", {})[dname] = t
            log(f"  time wkv6 {what:<19s} {dname:8s} kernel "
                f"{t['kernel']:.4f} ms  plain {t['plain']:.4f} ms  library "
                f"none (no one call)  bound {t['bound']:.6f} ms ({t['by']})  "
                f"[{list(WKV_SHAPES[what])}, the wrapper's pick]")
        for chunk in (0, CHUNK):
            t = timing(timed["prefill"], kernel(chunk), plain=False)
            log(f"  time wkv6 prefill {'step' if not chunk else f'C={chunk}':<11s}"
                f" {dname:8s} kernel {t['kernel']:.4f} ms  bound "
                f"{t['bound']:.6f} ms  [{list(full)}]")
        if dname != "bfloat16":
            continue
        for nb, n in WKV_SWEEP:
            args = wkv6_inputs(g, dev, dt, (nb, n, 64, 64))
            ts = {chunk: timing(args, kernel(chunk), plain=False)["kernel"]
                  for chunk in (0, CHUNK, None)}
            log(f"  time wkv6 sweep B={nb} S={n:<4d} bfloat16 step "
                f"{ts[0]:.4f} ms  C={CHUNK} {ts[CHUNK]:.4f} ms  pick "
                f"{ts[None]:.4f} ms  [[{nb}, {n}, 64, 64]]")
    return rows, out


# ---------------------------------------------------------------------------
# phase 3: the serving path at full width
# ---------------------------------------------------------------------------

ARCH = "llama32-3b"
LOGIT_MATCH_FLOOR = 0.90      # teacher-forced top-1 match, kernel vs plain
LOGIT_DRIFT_CEILING = 0.5     # max |logit difference|, kernel vs plain
# bf16: the plain path rounds the scores and the probabilities to bf16
# (as the JAX package does) where the kernels keep them in f32, and the
# difference compounds over the layers; logits have unit scale here.
# Where a model misses the floor or the ceiling for a reason the yardstick
# of its family shows (a more exact plain path moves it as far), the
# kernel path is held to land no further from the plain path than that
# yardstick does, within this margin in top-1 match and in max drift.
YARDSTICK_MARGIN = 0.05


def llama_config():
    """llama32-3b at full width, cut to LLAMA_DEPTH layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH), num_layers=LLAMA_DEPTH)


def cut_depth(params, depth: int = LLAMA_DEPTH):
    """``params`` on their first ``depth`` layers (copies of the blocks;
    the embedding, head and final norm shared)."""
    return {**params, "blocks": {k: v[:depth].clone()
                                 for k, v in params["blocks"].items()}}


def smoke_trace(cfg):
    """The serving phases' trace: 8 requests, prompts of 64–512 tokens,
    16–64 new tokens each, all arriving at once."""
    from repro_torch.runtime.request import make_poisson_trace
    return make_poisson_trace(8, rate=0, vocab_size=cfg.vocab_size,
                              prompt_lens=(64, 512), decode_lens=(16, 64),
                              seed=0, quantum=32)


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


def require_all_finished(what, trace, report):
    """Raise unless every request produced its full token count."""
    for req, m in zip(trace, report.metrics):
        if m.num_generated != req.max_new_tokens or \
                m.finish_reason != "length":
            raise AssertionError(
                f"{what}: request {m.rid} produced {m.num_generated} of "
                f"{req.max_new_tokens} tokens ({m.finish_reason})")


def expect_launches(what, counts, L, passes, flash, decode, paged, t=1,
                    quant=None, quant_steps=0, scan=0, p=1, cp=0, c=1,
                    branch=0):
    """The launches of one run: 2L+1 norm sites per forward pass (run once
    on the TP group at any t), layer 0's ln1 a B1 and the other 2L an
    add_rms_norm (each closes a residual add), one B2 per layer and rank of
    every prefill pass, one B3/B4 per layer and rank of every decode step,
    one B10 per layer of every RWKV-6 pass (``scan`` passes).  Each of the
    2L layer all-reduces of a quantized decode step adds one B5 per rank;
    int8 and fp8 then one B6 per rank, and the norm site after it is a
    dequantize_add_rms_norm (B9 + add + B1) in place of the add_rms_norm;
    int4 one chunk_quantize_pack (B6 + B7) and one nibble_reduce_requant
    (B8 + B7) per rank and one nibble_unpack_dequantize (B8 + B9).  On p
    pipeline stages an int8/fp8 step dequantizes the sum it ships at each
    of the p - 1 boundaries with the standalone B9 (chunk_dequantize), and
    the next stage's first norm is then an add_rms_norm.  Each of ``cp``
    context-parallel prefill passes (not in ``passes``) on c workers runs
    each shard's 2L norm sites (layer 0's ln1 a B1, 2L - 1 add_rms_norm),
    one B2 per layer, rank and shard, and B1 once at the head on the row
    the CP all-reduce hands it: c + 1 B1, c(2L - 1) add_rms_norm and
    L·t·c B2 a pass.  ``branch`` B1 more per layer of every pass are the
    hybrid family's branch norms (ln_attn, ln_ssm: 2)."""
    ar = 2 * L * quant_steps if quant else 0
    int4, int8 = (ar, 0) if quant == "int4" else (0, ar)
    hops = (p - 1) * quant_steps if int8 else 0
    want = {"rmsnorm": passes * (1 + branch * L) + cp * (c + 1),
            "add_rms_norm": 2 * L * passes - int8 + hops + cp * c * (2 * L - 1),
            "dequantize_add_rms_norm": int8 - hops,
            "flash_attention": L * t * (flash + c * cp),
            "decode_attention": L * t * decode,
            "paged_decode_attention": L * t * paged,
            "chunk_amax": ar * t, "chunk_quantize": int8 * t,
            "chunk_dequantize": hops, "chunk_quantize_pack": int4 * t,
            "nibble_reduce_requant": int4 * t,
            "nibble_unpack_dequantize": int4, "wkv6": L * scan}
    log(f"  launches {what}: {counts}")
    if counts != want:
        raise AssertionError(f"{what}: launches {counts} != expected {want}")


def rank_launches(L, lo, hi, passes, flash, decode, paged, t=1, quant=None,
                  quant_steps=0, cp=0):
    """The launches of ONE rank of a real TP group of t processes
    (``core.comm.DistGroup``) that runs the pipeline stage of layers
    [lo, hi) of L (TP alone: [0, L)): the virtual engine's launches for
    that rank, ``expect_launches`` cut to one rank and one stage.  The
    group-once work runs once on every rank: B1 for layer lo's ln1 on
    the first stage only (no residual add before it), add_rms_norm at
    every other norm site (2(hi - lo) + 1 on the last stage, the final
    norm) — or, on an int8/fp8 step (t > 1), dequantize_add_rms_norm at
    the 2(hi - lo) - 1 (+1 last) sites after an all-reduce and the
    standalone B9 for the sum a non-last stage ships.  The per-rank work
    is the rank's own: one B2/B3/B4 per layer of the stage, and per
    quantized all-reduce one B5 and one B6 (int4: one
    chunk_quantize_pack, nibble_reduce_requant and
    nibble_unpack_dequantize).  Each of ``cp`` context-parallel prefill
    passes (not in ``passes``) runs the rank's one shard: one B2 per
    layer of the stage, B1 for layer lo's ln1 on the first stage and
    again at the head on the last (on the row the CP all-reduce hands
    it), add_rms_norm at the shard's other 2(hi - lo) - 1 (first stage)
    or 2(hi - lo) norm sites: at [0, L), L B2, 2 B1 and 2L - 1
    add_rms_norm a pass."""
    n, first, last = hi - lo, int(lo == 0), int(hi == L)
    q = quant_steps if quant and t > 1 else 0
    int8, int4 = (0, q) if quant == "int4" else (q, 0)
    sites = 2 * n - 1 + last           # norm sites that close an all-reduce
    return {"rmsnorm": passes * first + cp * (first + last),
            "add_rms_norm": passes * (2 * n + last - first) - int8 * sites
            + cp * (2 * n - first),
            "dequantize_add_rms_norm": int8 * sites,
            "flash_attention": n * (flash + cp),
            "decode_attention": n * decode,
            "paged_decode_attention": n * paged,
            "chunk_amax": 2 * n * q, "chunk_quantize": 2 * n * int8,
            "chunk_dequantize": int8 * (1 - last),
            "chunk_quantize_pack": 2 * n * int4,
            "nibble_reduce_requant": 2 * n * int4,
            "nibble_unpack_dequantize": 2 * n * int4, "wkv6": 0}


def drive_counted(what, fn, totals, L, grad_mode=torch.inference_mode,
                  **expect):
    """Run one path with the launch counts set to 0 just before and read
    just after; hold them to their formula (``expect_launches``) and add
    them to ``totals``.  ``grad_mode``: the context it runs in (DTensor
    views need ``torch.no_grad``: an inference tensor takes no view
    metadata)."""
    from repro_torch.kernels import _build
    _build.reset_launches()
    with grad_mode():
        out = fn()
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    expect_launches(what, counts, L, **expect)
    for k in totals:
        totals[k] += counts[k]
    return out


def serving_phase(dev, smi):
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime.backends import make_backend
    from repro_torch.runtime.engine import InferenceEngine
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
        trace = smoke_trace(cfg)
        backend = make_backend("gspmd", cfg, params, num_slots=4,
                               max_len=1024, device=dev, **kw)
        _build.reset_launches()
        report = Scheduler(backend, chunk_size=chunk).run(trace)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        require_all_finished(mode, trace, report)
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
    MEASURED[ROOFLINE_STEPS[0]] = decode_breakdown(
        dev, get_model(cfg), params, smi, "t=1")
    MEASURED[ROOFLINE_STEPS[1]] = prefill_breakdown(
        dev, get_model(cfg), params, smi)[:2]
    serve_launcher_run(dev, cfg, params, totals)
    return params, totals


SERVE_ARGV = ["--arch", ARCH, "--batch", "4", "--prompt-len", "32",
              "--new-tokens", "16"]


def serve_launcher_run(dev, cfg, params, totals):
    """Phase 3(d): ``python -m repro_torch.launch.serve`` as a user runs
    it (``main(SERVE_ARGV)``, on the card by default): its launches equal
    the formula, and its printed first sequence equals
    ``InferenceEngine.generate`` on the same seed's weights (``params``,
    seed 0) and the prompts it drew."""
    import io
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import InferenceEngine

    buf = io.StringIO()
    n = int(SERVE_ARGV[SERVE_ARGV.index("--new-tokens") + 1])
    t0 = time.perf_counter()

    def run():
        with contextlib.redirect_stdout(buf):
            return serve.main(SERVE_ARGV)
    prompts, out = drive_counted("launch.serve", run, totals, cfg.num_layers,
                                 passes=n, flash=1, decode=n - 1, paged=0)
    wall = time.perf_counter() - t0
    printed = buf.getvalue()
    for line in printed.splitlines():
        log(f"[launch.serve] {line}")
    want = InferenceEngine(cfg, params, max_len=prompts.shape[1] + n + 8,
                           device=dev).generate(prompts, max_new_tokens=n)
    same = (f"first sequence: {want[0].tolist()}" in printed
            and torch.equal(out, want))
    log(f"[launch.serve] {' '.join(SERVE_ARGV)}: {wall:.2f} s with its "
        f"init; first sequence equal to InferenceEngine.generate on the "
        f"seed's weights and its prompts: {same}")
    if not same:
        raise AssertionError("launch.serve's tokens differ from the "
                             "engine's")


def decode_breakdown(dev, model, params, smi, what: str, steps: int = 8,
                     ranged: str = None):
    """Where one decode step's time goes at 4 slots: host wall per step
    (synchronised, no profiler), the device's busy time per step from
    torch.profiler's kernel records (``device_busy_us``; idle share = 1 -
    busy / wall), the hand-written kernels' launches per step and the
    device kernels per step the profiler saw; with ``ranged`` (a
    ``record_function`` range of RANGES the caller wraps a function in)
    also that range's host and device ms per step (``range_times``).
    Returns (host wall ms, device busy ms or None) per step; the
    profiled steps sit at positions 130 + steps .. 130 + 2·steps - 1."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build

    cfg = model.cfg
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
        _build.reset_launches()
        t0 = time.perf_counter()
        cache, tok = run(steps, cache, tok, 130)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
        ours = sum(_build.LAUNCHES.values()) / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cache, tok = run(steps, cache, tok, 130 + steps)
            torch.cuda.synchronize()
    events = device_events(prof)
    busy_us, summed_us = device_busy_us(prof)
    kernels = sum(e.count for e in events) / steps
    pair = sum(e.self_device_time_total for e in events
               if "split_kernel" in e.key or "combine_kernel" in e.key)
    if busy_us <= 0:
        log(f"[decode step {what}] 4 slots: host wall {wall_ms:.3f} ms/step; "
            "device busy: not measured (profiler recorded no device time)")
        return wall_ms, None
    busy_ms = busy_us / 1e3 / steps
    log(f"[decode step {what}] 4 slots at pos ~130: host wall "
        f"{wall_ms:.3f} ms/step (no profiler), device busy {busy_ms:.3f} "
        f"ms/step (profiler, union of kernel intervals; their sum "
        f"{summed_us / 1e3 / steps:.3f}), device idle share "
        f"{1 - busy_ms / wall_ms:.3f}, "
        f"hand-written kernel launches {ours:.0f}/step, device kernels "
        f"{kernels:.0f}/step (profiler), split-KV decode pair (split + "
        f"combine) {pair / 1e3 / steps:.3f} ms/step ({smi})")
    if ranged:
        host_ms, dev_ms = (v / steps for v in range_times(prof, ranged))
        log(f"[decode step {what}] {ranged}: device {dev_ms:.3f} ms/step = "
            f"{dev_ms / busy_ms:.3f} of device busy"
            if dev_ms > 0 else f"[decode step {what}] {ranged}: device time "
            "not measured (no device time under the range)")
        log(f"[decode step {what}] {ranged}: host {host_ms:.3f} ms/step "
            "(profiled)")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"    device {e.self_device_time_total / 1e3 / steps:8.3f} "
            f"ms/step {e.count // steps:5d}/step  {e.key[:90]}")
    host = sorted((e for e in prof.key_averages() if e not in events),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    for e in host:
        log(f"    host   {e.self_cpu_time_total / 1e3 / steps:8.3f} "
            f"ms/step {e.count // steps:5d}/step  {e.key[:90]}")
    return wall_ms, busy_ms


# record_function labels of the breakdowns: on the card the profiler shows
# each as a span from its first to its last device record, gaps included
RANGES = ("pp.boundary_hop", "cp.ring", "moe.ffn", "hybrid.scan",
          "train.fwd", "train.bwd", "train.opt")


def _on_card(e) -> bool:
    return (getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA"))


def _work_on_card(e) -> bool:
    """A kernel or copy that ran on the card (not a labelled range)."""
    return (_on_card(e) and e.key not in RANGES
            and not getattr(e, "is_user_annotation", False))


def device_events(prof):
    """The profiler's per-kernel records that ran on the card."""
    return [e for e in prof.key_averages() if _work_on_card(e)]


def device_busy_us(prof):
    """(busy, summed) us of the card in the profiled window: busy is the
    union of the intervals of the records that ran on it (kernels, copies;
    not the labelled ranges, whose spans hold the gaps between them),
    so records that overlap — B5 and B6 start while their predecessor
    drains, by programmatic dependent launch — count once; summed adds
    their durations, as the breakdowns before the union did."""
    spans = [(e.time_range.start, e.time_range.end)
             for e in prof.events() if _work_on_card(e)]
    return _union_us(spans), sum(b - a for a, b in spans)


def _union_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def prefill_breakdown(dev, model, params, smi, S: int = 333,
                      kernel: str = "flash_prefill", label: str = "B2",
                      ranged: str = None, run=None):
    """One full-width prefill pass of one S-token prompt (or ``run()``, a
    pass of S positions the caller sets up): host wall (synchronised, no
    profiler), device busy from torch.profiler's kernel records
    (``device_busy_us``), and one kernel's share of it (the records whose
    name holds ``kernel``: B2's flash_prefill by default); with
    ``ranged`` (a ``record_function`` range of RANGES the caller wraps a
    function in) also that range's share of the profiled pass's host wall
    and of device busy (``range_times``).  Returns (host wall ms, device
    busy ms, the kernel's device ms)."""
    from torch.profiler import ProfilerActivity, profile

    if run is None:
        prompt = torch.randint(2, model.cfg.vocab_size, (1, S), device=dev,
                               generator=torch.Generator(dev).manual_seed(9))

        def run():
            model.prefill(params, prompt, 1024)
    with torch.inference_mode():
        run()                                                # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            prof_ms = 1e3 * (time.perf_counter() - t0)
    events = device_events(prof)
    busy_us, summed_us = device_busy_us(prof)
    busy_ms = busy_us / 1e3
    if busy_ms <= 0:
        log(f"[prefill pass] S={S}: host wall {wall_ms:.3f} ms; device busy: "
            "not measured (profiler recorded no device time)")
        return wall_ms, None, None
    mine = [e for e in events if kernel in e.key]
    mine_ms = sum(e.self_device_time_total for e in mine) / 1e3
    log(f"[prefill pass] {model.cfg.name} S={S}, 1 prompt: host wall "
        f"{wall_ms:.3f} ms (no profiler), device busy {busy_ms:.3f} ms "
        f"(profiler, union; sum {summed_us / 1e3:.3f}), {label} {mine_ms:.3f} ms in "
        f"{sum(e.count for e in mine)} launches = {mine_ms / busy_ms:.3f} "
        f"of device busy, device idle share {1 - busy_ms / wall_ms:.3f} "
        f"({smi})")
    if ranged:
        host_ms, dev_ms = range_times(prof, ranged)
        log(f"[prefill pass] {ranged}: host {host_ms:.3f} ms = "
            f"{host_ms / prof_ms:.3f} of the profiled pass's host wall "
            f"({prof_ms:.3f} ms), device "
            + (f"{dev_ms:.3f} ms = {dev_ms / busy_ms:.3f} of device busy"
               if dev_ms > 0 else "time not measured (no device time under "
               "the range)"))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    device {e.self_device_time_total / 1e3:8.3f} ms "
            f"{e.count:5d}x  {e.key[:90]}")
    return wall_ms, busy_ms, mine_ms


# ---------------------------------------------------------------------------
# phase 4: the kernel path against the plain path on the whole model
# ---------------------------------------------------------------------------

SPLIT, FORCED = 128, 256       # teacher-forced positions SPLIT-1 .. FORCED-1


def teacher_forced(model, params, prompt, paged: bool, prefix_emb=None):
    """Next-token logits at positions SPLIT-1 .. FORCED-1 of ``prompt``
    [1, FORCED]: a prefill (or a paged chunk) of the first SPLIT tokens,
    then one decode step per remaining prompt token.  ``model`` is a
    ``Model`` or a ``TPModel`` (the same interface).  ``prefix_emb`` [1, P,
    h] (a vlm's image prefix, contiguous only) goes before the tokens, so
    token i sits at position P + i."""
    dev = prompt.device
    npre = 0 if prefix_emb is None else prefix_emb.shape[1]
    rows = []
    with torch.inference_mode():
        if paged:
            ps = 16
            cache = model.init_paged_cache(1 + FORCED // ps, ps, dev)
            bt = torch.arange(1, 1 + FORCED // ps, device=dev,
                              dtype=torch.int32)[None]
            pos = torch.zeros(1, dtype=torch.int32, device=dev)
            logits, cache = model.paged_step(params, cache,
                                             prompt[:, :SPLIT], pos, bt)
        else:
            kw = {} if prefix_emb is None else {"prefix_emb": prefix_emb}
            logits, cache, _ = model.prefill(params, prompt[:, :SPLIT],
                                             npre + FORCED, **kw)
        rows.append(logits)
        for i in range(SPLIT, FORCED):
            if paged:
                pos = torch.full((1,), i, dtype=torch.int32, device=dev)
                logits, cache = model.paged_step(params, cache,
                                                 prompt[:, i:i + 1], pos, bt)
            else:
                logits, cache = model.decode_step(params, cache,
                                                  prompt[:, i], npre + i)
            rows.append(logits)
    return torch.cat(rows).float()


def agreement(got, ref):
    """(top-1 match, max logit drift) of ``got`` against ``ref``."""
    return (float((got.argmax(-1) == ref.argmax(-1)).float().mean()),
            float((got - ref).abs().max()))


def within(what, got, ref, floor: float, ceiling: float) -> bool:
    """Log the top-1 match and max logit drift of ``got`` against ``ref``;
    True when the match is at least ``floor``, the drift at most
    ``ceiling`` and every logit finite."""
    match, drift = agreement(got, ref)
    ok = (match >= floor and drift <= ceiling
          and bool(torch.isfinite(got).all()))
    log(f"[compare] {what}, {ref.shape[0]} teacher-forced positions: top-1 "
        f"match {match:.4f} (floor {floor}), max logit drift {drift:.4f} "
        f"(ceiling {ceiling}): {'ok' if ok else 'FAIL'}")
    return ok


def hold(what, got, ref, floor: float, ceiling: float) -> None:
    if not within(what, got, ref, floor, ceiling):
        raise AssertionError(f"{what}: drifted past its tolerance")


def exact_attention(fn):
    """fn() with the plain path's attention in f64 (the yardstick)."""
    from repro_torch.models import blocks
    plain_attention = blocks.gqa_attention
    blocks.gqa_attention = gqa_attention_exact
    try:
        return fn()
    finally:
        blocks.gqa_attention = plain_attention


def gqa_attention_exact(q, k, v, mask):
    """``layers.gqa_attention`` in f64 (scores, softmax, P·V), rounded once
    to the input type: the yardstick of how far an attention more exact
    than the plain path's (which rounds scores and probabilities to bf16)
    moves the bf16 model."""
    from repro_torch.models.layers import NEG_INF
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.double().reshape(B, S, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.double()) / D ** 0.5
    probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.double())
    return out.reshape(B, S, Hq, D).to(q.dtype)


def model_compare_phase(dev, params):
    """Returns (prompt, the kernel path's contiguous teacher-forced
    logits), which the TP phase holds its engine to."""
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime.engine import InferenceEngine

    cfg = llama_config()
    prompt = torch.randint(2, cfg.vocab_size, (1, FORCED),
                           generator=torch.Generator().manual_seed(2)).to(dev)
    ref = teacher_forced(get_model(cfg, plain=True), params, prompt, False)
    # the yardstick (logged, holds nothing): the plain path with f64
    # attention against the plain path
    exact = exact_attention(lambda: teacher_forced(
        get_model(cfg, plain=True), params, prompt, False))
    match, drift = agreement(exact, ref)
    log(f"[compare] bf16 {ARCH} plain path with f64 attention vs plain (the "
        f"yardstick), {ref.shape[0]} teacher-forced positions: top-1 match "
        f"{match:.4f}, max logit drift {drift:.4f}")
    kernel_rows = None
    for paged in (False, True):
        got = teacher_forced(get_model(cfg), params, prompt, paged)
        what = "paged (B2 chunk + B4)" if paged else "contiguous (B2 + B3)"
        hold(f"bf16 {what} vs plain", got, ref, LOGIT_MATCH_FLOOR,
             LOGIT_DRIFT_CEILING)
        if not paged:
            kernel_rows = got

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
    return prompt, kernel_rows


# ---------------------------------------------------------------------------
# phase 5: the explicit TP engine on virtual ranks, full width
# ---------------------------------------------------------------------------

TP = 4                  # virtual ranks: 6 query / 2 KV heads each
TP_PROMPT = 32          # prompt length of the comm-log pass
QUANT_MODES = ("int8", "fp8", "int4")

# Quantized TP against unquantized TP at full width (phase 5c).
# QUANT_TOLERANCE is the JAX package's contract, calibrated on reduced
# configs.  At the full width of llama32-3b (bf16, t = 4, 28 layers,
# random weights from seed 0, phase 4's 129 teacher-forced positions; at
# LLAMA_DEPTH = 8 of them the top-1 match / max drift are int8 0.8760 /
# 0.2617, fp8 0.8915 / 0.3027, int4 0.3101 / 2.6133, each still outside
# QUANT_TOLERANCE) a
# mode can miss it while quantized_psum with kernels is bit for bit the
# plain version (5d, which runs first and raises on any difference): the
# miss is then the contract's, not the kernels'.  Such a mode is held to
# (5d) and to the limits below, set beside the values measured on the
# card (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W); QUANT_TOLERANCE
# stays as the JAX package has it (ROADMAP C6).  A mode not listed is
# held to QUANT_TOLERANCE.
FULL_WIDTH_QUANT_LIMITS = {
    # mode: measured at 28 layers (top-1 match, max drift) -> (floor, ceiling)
    "int8": dict(measured=(0.8372, 0.3516), floor=0.80, ceiling=0.50),
    "fp8": dict(measured=(0.7984, 0.4453), floor=0.75, ceiling=0.65),
    "int4": dict(measured=(0.1550, 3.0010), floor=0.10, ceiling=4.5),
}


def tp_greedy(model, params, prompts, max_len: int, n: int):
    """Greedy tokens [B, n] of a TP model: a prefill, then n-1 steps."""
    with torch.inference_mode():
        logits, cache, S = model.prefill(params, prompts, max_len)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        rest, _ = model.decode_steps(params, cache, tok, S, n - 1)
    return torch.cat([tok[:, None], rest], dim=1)


def tp_phase(dev, smi, params, prompt, kernel_rows):
    from repro_torch.core import comm
    from repro_torch.core.commodel import comm_ops_for
    from repro_torch.core.parallel_exec import (TPModel, quantized_psum,
                                                shard_params)
    from repro_torch.kernels import _build
    from repro_torch.kernels.quant_collective import QUANT_TOLERANCE
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime.backends import make_backend
    from repro_torch.runtime.engine import InferenceEngine
    from repro_torch.runtime.scheduler import Scheduler

    cfg = llama_config()
    L = cfg.num_layers
    totals = {name: 0 for name in _build.LAUNCHES}

    def drive(what, fn, **expect):
        return drive_counted(what, fn, totals, L, **expect)

    t0 = time.perf_counter()
    shards = shard_params(cfg, params, TP)
    torch.cuda.synchronize()
    log(f"[tp] {ARCH} t={TP} virtual ranks: {cfg.num_heads // TP} query / "
        f"{cfg.num_kv_heads // TP} KV heads, d_ff {cfg.d_ff // TP}, vocab "
        f"shard {cfg.padded_vocab // TP} per rank; sharded in "
        f"{time.perf_counter() - t0:.2f} s")

    # (a) collectives and (e) launches: one prefill pass, one decode step
    prompt_a = torch.randint(2, cfg.vocab_size, (1, TP_PROMPT),
                             generator=torch.Generator().manual_seed(6)).to(dev)
    for t, quant in [(TP, None)] + [(TP, q) for q in QUANT_MODES] + [(2, None)]:
        ranks = shards if t == TP else shard_params(cfg, params, t)
        model = TPModel(cfg, t, quant=quant)
        logits, cache, S = drive(
            f"tp t={t} {quant} prefill",
            lambda: model.prefill(ranks, prompt_a, 2 * TP_PROMPT),
            passes=1, flash=1, decode=0, paged=0, t=t)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        drive(f"tp t={t} {quant} decode step",
              lambda: model.decode_step(ranks, cache, tok, S),
              passes=1, flash=0, decode=1, paged=0, t=t, quant=quant,
              quant_steps=1)
        want = comm_ops_for(cfg, TP_PROMPT, 2, t, batch=1,
                            b=torch_dtype(cfg.dtype).itemsize,
                            gather_mode="allgather", quant=quant)
        got = model.group.summary()
        same = comm.fold(got) == comm.fold(want)
        log(f"[tp collectives] t={t} quant={quant}: logged "
            f"{comm.counts_by_collective(got)}, "
            f"{sum(o.wire_bytes for o in got):.0f} wire bytes; "
            f"comm_ops_for: {comm.counts_by_collective(want)}, "
            f"{sum(o.wire_bytes for o in want):.0f}: "
            f"{'equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"t={t} quant={quant}: logged collectives "
                                 f"{got} != comm_ops_for {want}")
        del ranks, cache

    # (b) serving: TPBackend contiguous int8 and paged unquantized
    for mode, kw, chunk in (("contiguous int8",
                             dict(quant_collectives="int8"), None),
                            ("paged", dict(paged=True, page_size=16), 256)):
        trace = smoke_trace(cfg)
        backend = make_backend("tp", cfg, params, num_slots=4, max_len=1024,
                               t=TP, device=dev, **kw)
        finite = FiniteLogits(backend.model)
        scheduler = Scheduler(backend, chunk_size=chunk)
        _build.reset_launches()
        t0 = time.perf_counter()
        report = scheduler.run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        require_all_finished(f"tp {mode}", trace, report)
        n_dec = sum(1 for r in report.steps if r.phase == "decode")
        n_chunks = sum(1 for r in report.steps if r.phase == "prefill")
        if chunk:
            expect_launches(f"tp {mode}", counts, L, passes=n_chunks + n_dec,
                            flash=n_chunks, decode=0, paged=n_dec, t=TP)
        else:
            expect_launches(f"tp {mode}", counts, L,
                            passes=len(trace) + n_dec, flash=len(trace),
                            decode=n_dec, paged=0, t=TP, quant="int8",
                            quant_steps=n_dec)
        for k in totals:
            totals[k] += counts[k]
        # the decode steps' logged collectives against the prediction
        per_step = backend.decode_comm_ops(batch=backend.num_slots)
        want = {k: n * n_dec for k, n in comm.fold(per_step).items()}
        same = comm.fold(backend.model.group.summary("decode")) == want
        n = finite.assert_all(f"tp {mode}")
        log(f"[tp serve {mode}] {len(report.metrics)} requests, "
            f"{report.total_tokens} tokens, {n_dec} decode steps, "
            f"{n_chunks} prefill chunks in {wall:.2f} s, {n} logit batches "
            f"all finite; decode collectives == {n_dec} x decode_comm_ops: "
            f"{same} ({smi})")
        if not same:
            raise AssertionError(f"tp {mode}: logged decode collectives "
                                 f"differ from the prediction")
        del backend, scheduler

    # (d) quantized_psum alone: kernels == plain versions, bit for bit
    g = torch.Generator(device=dev).manual_seed(11)
    xs = [torch.randn(QDECODE, generator=g, device=dev).to(torch.bfloat16)
          for _ in range(TP)]
    for quant in QUANT_MODES:
        bitwise(f"quantized_psum t={TP} {quant} [4,3072] bf16",
                quantized_psum(xs, comm.VirtualGroup(TP), quant, QCHUNK),
                quantized_psum(xs, comm.VirtualGroup(TP), quant, QCHUNK,
                               plain=True))

    # (c) whole-model numerics, teacher-forced as in phase 4
    base = teacher_forced(TPModel(cfg, TP), shards, prompt, False)
    hold(f"bf16 TP t={TP} vs single-device kernel path", base, kernel_rows,
         LOGIT_MATCH_FLOOR, LOGIT_DRIFT_CEILING)
    missed = []
    for quant in QUANT_MODES:
        got = teacher_forced(TPModel(cfg, TP, quant=quant), shards, prompt,
                             False)
        limits = FULL_WIDTH_QUANT_LIMITS.get(quant)
        if limits is None:
            tol = QUANT_TOLERANCE[quant]
            floor, ceiling = tol["token_match_floor"], \
                tol["logit_drift_ceiling"]
            why = "QUANT_TOLERANCE"
        else:
            floor, ceiling = limits["floor"], limits["ceiling"]
            why = (f"full-width limits; measured {limits['measured']}, "
                   f"QUANT_TOLERANCE {tuple(QUANT_TOLERANCE[quant].values())}")
        if not within(f"bf16 TP t={TP} {quant} vs unquantized TP ({why})",
                      got, base, floor, ceiling):
            missed.append(quant)
    if missed:
        raise AssertionError(f"quantized TP drifted past its limits: {missed}")
    cfg32 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    p32 = get_model(cfg32).init(seed=3, device=dev)
    prompts = torch.randint(2, cfg.vocab_size, (2, 128),
                            generator=torch.Generator().manual_seed(4))
    a = InferenceEngine(cfg32, p32, max_len=256, device=dev).generate(
        prompts, max_new_tokens=32)
    b = tp_greedy(TPModel(cfg32, TP), shard_params(cfg32, p32, TP),
                  prompts.to(dev), 256, 32)
    same = bool(torch.equal(a, b))
    log(f"[compare f32] L=4 full width, greedy 2x32 tokens TP t={TP} == "
        f"single-device: {same}")
    if not same:
        raise AssertionError("f32 greedy tokens differ between TP and the "
                             "single-device path")
    del p32

    one_rank_nccl(dev, cfg, params)
    for quant in (None, "int8", "int4"):
        decode_breakdown(dev, TPModel(cfg, TP, quant=quant), shards, smi,
                         f"t={TP} {quant or 'unquantized'}")
    return totals


NCCL_PROMPT, NCCL_NEW = 64, 16


def one_rank_nccl(dev, cfg, params):
    """(f) ``TPModel`` at t = 1 on a ``DistGroup`` of one NCCL rank (a
    ``HashStore``, no network) against the virtual t = 1 run: a prefill
    and NCCL_NEW greedy steps, logits and tokens bit for bit, each run's
    launches its formula (not added to the phase's totals), and one
    ``SharedClock`` reading, an NCCL broadcast: the NCCL start-up of the
    real-rank engines on this host."""
    import torch.distributed as dist

    from repro_torch.core.comm import dist_groups
    from repro_torch.core.parallel_exec import TPModel, shard_params
    from repro_torch.runtime.scheduler import SharedClock, WallClock

    t0 = time.perf_counter()
    L = cfg.num_layers
    prompt = torch.randint(2, cfg.vocab_size, (1, NCCL_PROMPT),
                           generator=torch.Generator().manual_seed(30)
                           ).to(dev)
    shards = shard_params(cfg, params, 1)

    def greedy(model):
        logits, cache, S = model.prefill(shards, prompt, 2 * NCCL_PROMPT)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks, _ = model.decode_steps(shards, cache, tok, S, NCCL_NEW)
        return logits, toks

    expect = dict(passes=1 + NCCL_NEW, flash=1, decode=NCCL_NEW, paged=0)
    want = drive_counted("tp t=1 virtual", lambda: greedy(TPModel(cfg, 1)),
                         {}, L, **expect)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        place = dist_groups(1, 1, dev)
        got = drive_counted("tp t=1 on one NCCL rank", lambda: greedy(
            TPModel(cfg, 1, group=place.group)), {}, L, **expect)
        now = SharedClock(WallClock(), dev).now()
    finally:
        dist.destroy_process_group()
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    log(f"[tp one NCCL rank] t=1 DistGroup on {place.device}: prefill of "
        f"{NCCL_PROMPT} + {NCCL_NEW} greedy steps, logits and tokens == the "
        f"virtual t=1 run bit for bit: {same}; SharedClock read {now:.6f} "
        f"s; {time.perf_counter() - t0:.1f} s with the NCCL start-up")
    if not same:
        raise AssertionError("TPModel on one NCCL rank != virtual t=1")


# ---------------------------------------------------------------------------
# phase 6: the RWKV-6 path at full width
# ---------------------------------------------------------------------------

RWKV_ARCH = "rwkv6-7b"
# bf16 kernel path vs plain path, teacher-forced (phase 6d).  B10 and the
# plain recurrence both keep the state in f32 and differ in its last bits
# (FMA, summation order), so about 1.5e-4 of the bf16 y values round one
# ulp apart; with random weights the model amplifies that over 32 layers
# and 129 positions.  The yardstick is the plain path with an exact (f64)
# recurrence, which moves it as far: the kernel path is held to land no
# further from the plain path than the yardstick does, within
# YARDSTICK_MARGIN in top-1 match and in max drift.  Measured on the card (chip_smoke.py,
# NVIDIA H100 80GB HBM3, 700.00 W, seed 0): kernel path vs plain 0.8372 /
# 0.3994, exact recurrence vs plain 0.8605 / 0.4118 (top-1 match / max
# drift).


def wkv6_exact(r, k, v, w, u, state):
    """The WKV recurrence in f64, rounded once at the end: the yardstick
    of how far any f32 recurrence moves the bf16 model."""
    rf, kf, vf, wf = (t.double() for t in (r, k, v, w))
    uf = u.double()[None, :, :, None]
    s = state.double()
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], s + uf * kv))
        s = wf[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s.float()


def rwkv_phase(dev, smi):
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import Model, get_model
    from repro_torch.runtime.backends import make_backend
    from repro_torch.runtime.engine import InferenceEngine
    from repro_torch.runtime.scheduler import Scheduler

    cfg = get_config(RWKV_ARCH)
    L = cfg.num_layers
    totals = {name: 0 for name in _build.LAUNCHES}

    def drive(what, fn, passes):
        """B1 (2L+1) and B10 (L) per pass, no B2–B9."""
        return drive_counted(what, fn, totals, L, passes=passes, flash=0,
                             decode=0, paged=0, scan=passes)

    t0 = time.perf_counter()
    params = get_model(cfg).init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["blocks"].values()) + sum(
        params[k].numel() for k in ("embed", "lm_head", "final_norm"))
    log(f"[rwkv] {RWKV_ARCH} full width: L={L} d={cfg.d_model} heads="
        f"{cfg.num_heads}x{cfg.ssm.head_size} d_ff={cfg.d_ff} vocab="
        f"{cfg.vocab_size} {cfg.dtype}, {n_params / 1e9:.3f} B parameters, "
        f"init {time.perf_counter() - t0:.1f} s")
    finite = FiniteLogits(get_model(cfg))

    # (a) the engine: 2 prompts x 128 tokens, 32 new tokens each
    prompts = torch.randint(2, cfg.vocab_size, (2, 128),
                            generator=torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    out = drive("rwkv engine", lambda: InferenceEngine(
        cfg, params, max_len=1024, decode_chunk=8, device=dev).generate(
        prompts, max_new_tokens=32), passes=32)
    wall = time.perf_counter() - t0
    if tuple(out.shape) != (2, 32) or int(out.min()) < 0 or \
            int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"engine output {tuple(out.shape)} out of range")
    log(f"[rwkv engine] generate 2x128 -> 2x32 tokens in {wall:.3f} s ({smi})")

    # (b) the contiguous Scheduler over the trace, 4 slots
    trace = smoke_trace(cfg)
    backend = make_backend("gspmd", cfg, params, num_slots=4, max_len=1024,
                           device=dev)
    scheduler = Scheduler(backend)
    _build.reset_launches()
    t0 = time.perf_counter()
    report = scheduler.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    require_all_finished("rwkv contiguous", trace, report)
    n_dec = sum(1 for r in report.steps if r.phase == "decode")
    expect_launches("rwkv contiguous", counts, L, passes=len(trace) + n_dec,
                    flash=0, decode=0, paged=0, scan=len(trace) + n_dec)
    for k in totals:
        totals[k] += counts[k]
    n = finite.assert_all("rwkv serving")
    log(f"[rwkv serve contiguous] {len(report.metrics)} requests, "
        f"{report.total_tokens} tokens, {n_dec} decode steps in {wall:.2f} "
        f"s, {n} logit batches all finite ({smi})")
    log(f"[rwkv serve contiguous] summary {json.dumps(report.summary())}")
    del backend, scheduler

    # (d) the kernel path against the plain path on the whole model
    prompt = torch.randint(2, cfg.vocab_size, (1, FORCED),
                           generator=torch.Generator().manual_seed(2)).to(dev)
    plain = get_model(cfg, plain=True)
    ref = teacher_forced(plain, params, prompt, False)
    got = drive("rwkv teacher-forced",
                lambda: teacher_forced(get_model(cfg), params, prompt, False),
                passes=1 + FORCED - SPLIT)

    class ExactScan(Model):
        """The plain path with ``wkv6_exact`` as its recurrence."""

        def _block(self, p_l, x, positions, **kw):
            return super()._block(p_l, x, positions, scan=wkv6_exact, **kw)

    exact = teacher_forced(ExactScan(cfg, plain=True), params, prompt, False)
    match, drift = agreement(exact, ref)
    log(f"[compare] bf16 rwkv6-7b plain path with an exact (f64) recurrence "
        f"vs plain (the yardstick): top-1 match {match:.4f}, max logit "
        f"drift {drift:.4f}")
    hold("bf16 rwkv6-7b kernel path (B1 + B10) vs plain, held to the "
         f"yardstick's {match:.4f} / {drift:.4f} within {YARDSTICK_MARGIN}",
         got, ref, match - YARDSTICK_MARGIN, drift + YARDSTICK_MARGIN)
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
    log(f"[compare f32] rwkv6-7b L=4 full width, greedy 2x32 tokens kernel "
        f"path == plain path: {same}")
    if not same:
        raise AssertionError("rwkv f32 greedy tokens differ between the "
                             "kernel and the plain path")
    del p32

    # (e) one decode step's breakdown at 4 slots
    decode_breakdown(dev, get_model(cfg), params, smi, RWKV_ARCH)
    # (f) one 512-token prefill pass, B10 as the wrapper picks it (the
    # chunked kernel), then with the per-step kernel forced
    from repro_torch.kernels.rwkv6_scan import ops as wops
    prefill_breakdown(dev, get_model(cfg), params, smi, 512, "wkv6_",
                      "B10 (chunked)")
    pick = wops.CHUNK_MAX_CTAS
    wops.CHUNK_MAX_CTAS = 0
    try:
        prefill_breakdown(dev, get_model(cfg), params, smi, 512, "wkv6_",
                          "B10 (per-step kernel forced)")
    finally:
        wops.CHUNK_MAX_CTAS = pick
    return totals


# ---------------------------------------------------------------------------
# phase 7: the pipeline and hybrid engines on virtual stages, full width
# ---------------------------------------------------------------------------

PP_LAYOUTS = ((1, 4), (2, 2))       # (t, p)
PP_PROMPTS = 4                      # prompts of the smoke trace in (a)
PP_NEW = 16                         # greedy tokens per prompt in (a)
# phases 7(c) and 8(e) serve the trace's first 5 requests (4 slots: one
# is refilled), not all 8, to keep the smoke inside its time limit
SERVE_REQUESTS = 5
# (c): (t, p, inflight, paged, quant) over the smoke trace, 4 slots
PP_SERVE = ((1, 4, 1, False, None), (1, 4, 4, False, None),
            (2, 2, 2, True, None), (2, 2, 1, False, "int8"))
# (e): (kind, t, p, inflight); the single-stage rounds first, through the
# same backend and queue machinery, as the layouts' baselines
PP_BREAKDOWN = (("gspmd", 1, 1, 1), ("pp", 1, 4, 1), ("pp", 1, 4, 4),
                ("tp", 2, 1, 1), ("pp", 2, 2, 1))


def pp_reference(cfg, params, t):
    """The single-stage path a layout is bitwise held to: ``Model`` at
    t = 1, ``TPModel`` on its own shards at t > 1."""
    from repro_torch.core.parallel_exec import TPModel, shard_params
    from repro_torch.models.transformer import get_model
    if t == 1:
        return get_model(cfg), params
    return TPModel(cfg, t), shard_params(cfg, params, t)


def pp_greedy(prompt, n: int, prefill, generate, step):
    """(prefill logits, n greedy tokens, the logits of one more step):
    ``prefill(prompt)``, ``generate(cache, tok, pos, n - 1)``, then
    ``step(cache, tok, pos)``."""
    S = prompt.shape[1]
    logits, cache = prefill(prompt)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    gen, cache = generate(cache, tok, S, n - 1)
    last, _ = step(cache, gen[:, -1], S + n - 1)
    return logits, torch.cat([tok[:, None], gen], dim=1), last


def pp_check_stage_logs(what, eng, cfg, t, p, passes, quant=None, c=1):
    """Each stage's logged collectives per phase == ``passes[phase]`` x
    ``commodel.hybrid_stage_collectives`` (nothing at t = c = 1)."""
    from repro_torch.core import comm
    from repro_torch.core.commodel import hybrid_stage_collectives
    for s, m in enumerate(eng.stages):
        for phase, n in passes.items():
            want = {k: v * n for k, v in hybrid_stage_collectives(
                cfg, t, p, s, c=c, phase=phase,
                quant=quant if phase == "decode" else None).items()}
            got = comm.counts_by_collective(m.group.summary(phase))
            if got != want:
                raise AssertionError(f"{what}: stage {s} {phase} logged "
                                     f"{got} != {want}")


def pp_phase(dev, smi, params):
    from repro_torch.core.commodel import hybrid_comm_ops, pp_comm_ops, \
        pp_schedule_stats
    from repro_torch.core.parallel_exec import PipelineEngine
    from repro_torch.kernels import _build
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime.backends import make_backend
    from repro_torch.runtime.request import Request
    from repro_torch.runtime.scheduler import Scheduler

    cfg = llama_config()
    L = cfg.num_layers
    b = torch_dtype(cfg.dtype).itemsize
    totals = {name: 0 for name in _build.LAUNCHES}
    t_phase = time.perf_counter()
    prompts = [torch.as_tensor(r.prompt, dtype=torch.int32, device=dev)[None]
               for r in smoke_trace(cfg)[:PP_PROMPTS]]

    # (a) engine parity, (b) transfers and stage logs, (d) launches
    for t, p in PP_LAYOUTS:
        ref, ref_params = pp_reference(cfg, params, t)
        eng = PipelineEngine(cfg, t=t, p=p, device=dev)
        staged = eng.prepare(params)
        w = eng.cache_width(1024)
        same_logits = same_tokens = True
        for prompt in prompts:
            S = prompt.shape[1]
            eng.transfers.clear()
            for m in eng.stages:
                m.group.log.clear()
            got = drive_counted(
                f"pp t={t} p={p} S={S} engine", lambda: pp_greedy(
                    prompt, PP_NEW,
                    lambda x: eng.prefill_with_cache(staged, x, w),
                    lambda *a: eng.generate(staged, *a),
                    lambda *a: eng.decode_once(staged, *a)),
                totals, L, passes=1 + PP_NEW, flash=1, decode=PP_NEW,
                paged=0, t=t)
            with torch.inference_mode():
                want = pp_greedy(
                    prompt, PP_NEW,
                    lambda x: ref.prefill(ref_params, x, 1024)[:2],
                    lambda *a: ref.decode_steps(ref_params, *a),
                    lambda *a: ref.decode_step(ref_params, *a))
            same_logits &= torch.equal(got[0], want[0]) and \
                torch.equal(got[2], want[2])
            same_tokens &= torch.equal(got[1], want[1])
            s_d = PP_NEW + 1
            ops = (pp_comm_ops(cfg, S, s_d, p, b=b) if t == 1 else
                   hybrid_comm_ops(cfg, S, s_d, t, p, b=b,
                                   gather_mode="allgather"))
            for phase in ("prefill", "decode"):
                row = [o for o in ops
                       if o.collective == "send" and o.phase == phase][0]
                summ = eng.transfer_summary(phase)
                if summ != {"count": row.count,
                            "bytes": row.total_msg_bytes}:
                    raise AssertionError(
                        f"pp t={t} p={p} S={S} {phase} transfers {summ} != "
                        f"{row.count} x {row.total_msg_bytes} bytes")
            pp_check_stage_logs(f"pp t={t} p={p} S={S}", eng, cfg, t, p,
                                {"prefill": 1, "decode": PP_NEW})
        what = "Model" if t == 1 else f"TPModel t={t}"
        log(f"[pp parity] t={t} p={p} {cfg.dtype}, {len(prompts)} prompts of the "
            f"trace, prefill + {PP_NEW - 1} generated + 1 step: tokens == "
            f"{what}: {same_tokens}, logits bitwise == {what}: {same_logits}"
            f"; transfers == {'pp' if t == 1 else 'hybrid'}_comm_ops send "
            f"rows (b={b}) and stage logs == hybrid_stage_collectives on "
            f"every prompt")
        if not (same_tokens and same_logits):
            raise AssertionError(f"pp t={t} p={p}: not bitwise the "
                                 f"{what} path")
        del eng, staged, ref, ref_params

    # (c) serving through Scheduler, (d) launches
    streams = {}
    for t, p, d, paged, quant in PP_SERVE:
        what = (f"pp t={t} p={p} inflight={d} "
                f"{'paged' if paged else 'contiguous'}"
                f"{' ' + quant if quant else ''}")
        trace = smoke_trace(cfg)[:SERVE_REQUESTS]
        kw = dict(paged=True, page_size=16) if paged else {}
        backend = make_backend("pp", cfg, params, num_slots=4, max_len=1024,
                               t=t, p=p, inflight=d, quant_collectives=quant,
                               device=dev, **kw)
        finite = FiniteLogits(backend.engine.stages[-1])
        scheduler = Scheduler(backend, chunk_size=256 if paged else None)
        _build.reset_launches()
        t0 = time.perf_counter()
        report = scheduler.run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        require_all_finished(what, trace, report)
        dec = [r for r in report.steps if r.phase == "decode"]
        n_dec = len(dec)
        n_chunks = sum(1 for r in report.steps if r.phase == "prefill")
        if paged:
            expect_launches(what, counts, L, passes=n_chunks + n_dec,
                            flash=n_chunks, decode=0, paged=n_dec, t=t, p=p)
        else:
            expect_launches(what, counts, L, passes=len(trace) + n_dec,
                            flash=len(trace), decode=n_dec, paged=0, t=t,
                            quant=quant, quant_steps=n_dec if quant else 0,
                            p=p)
        for k in totals:
            totals[k] += counts[k]
        pp_check_stage_logs(what, backend.engine, cfg, t, p,
                            {"decode": n_dec}, quant)
        send = [o for o in backend.decode_comm_ops(batch=backend.group_size)
                if o.collective == "send"][0]
        hops = {"count": send.count, "bytes": send.total_msg_bytes}
        if any(r.measured_transfers != hops for r in dec):
            raise AssertionError(f"{what}: a decode round's transfers differ "
                                 f"from {hops}")
        n = finite.assert_all(what)
        occ = report.occupancy()
        log(f"[pp serve {what}] {len(report.metrics)} requests, "
            f"{report.total_tokens} tokens, {n_dec} group rounds, {n_chunks} "
            f"prefill chunks in {wall:.2f} s, {n} logit batches all finite; "
            f"every round's transfers {hops}; schedule ticks {occ['ticks']}, "
            f"busy fraction per stage "
            f"{[round(f, 4) for f in occ['stage_busy_fraction']]} ({smi})")
        log(f"[pp serve {what}] summary {json.dumps(report.summary())}")
        streams[(t, p, d, paged, quant)] = report.tokens_by_rid()
        del backend, scheduler, finite
    a, b4 = streams[(1, 4, 1, False, None)], streams[(1, 4, 4, False, None)]
    same = sum(a[r] == b4[r] for r in a)
    log(f"[pp serve] t=1 p=4 streams at inflight 4 equal to inflight 1: "
        f"{same}/{len(a)} (bf16; a group of 1 row may take another GEMV "
        f"than a group of 4)")

    # the schedule clock on a one-wave trace: pp_schedule_stats
    rng = torch.Generator().manual_seed(8)
    for d in (1, 4):
        wave = [Request(rid=i, prompt=torch.randint(
            2, cfg.vocab_size, (64,), generator=rng).numpy(),
            max_new_tokens=PP_NEW) for i in range(4)]
        backend = make_backend("pp", cfg, params, num_slots=4, max_len=1024,
                               t=1, p=4, inflight=d, device=dev)
        scheduler = Scheduler(backend)
        scheduler.run(wave)
        q = scheduler._queue
        st = pp_schedule_stats(4, d, PP_NEW - 1)
        ok = (q.ticks == st.ticks and tuple(q.busy) == st.stage_forwards
              and q.idle == [st.ticks - x for x in st.stage_forwards])
        log(f"[pp schedule] one wave of 4 requests x {PP_NEW} tokens, t=1 "
            f"p=4 inflight={d}: ticks {q.ticks}, busy {q.busy}, idle "
            f"{q.idle}; pp_schedule_stats ticks {st.ticks}, busy "
            f"{list(st.stage_forwards)}: {'equal' if ok else 'DIFFERENT'}")
        if not ok:
            raise AssertionError("the queue's schedule clock differs from "
                                 "pp_schedule_stats")
        del backend, scheduler

    # streams at inflight d == inflight 1 == single device, f32 at L = 4
    cfg32 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    p32 = get_model(cfg32).init(seed=3, device=dev)
    same = True
    for paged in (False, True):
        kw, chunk = (dict(paged=True, page_size=16), 256) if paged else \
            ({}, None)
        f32 = {}
        layouts = ((2, 2, 1), (2, 2, 2)) if paged else ((1, 4, 1), (1, 4, 4))
        for key, kind, t, p, d in (("one device", "gspmd", 1, 1, 1), *(
                (f"t={t} p={p} inflight={d}", "pp", t, p, d)
                for t, p, d in layouts)):
            backend = make_backend(kind, cfg32, p32, num_slots=4,
                                   max_len=1024, t=t, p=p, inflight=d,
                                   device=dev, **kw)
            f32[key] = Scheduler(backend, chunk_size=chunk).run(
                smoke_trace(cfg32)[:4]).tokens_by_rid()
            del backend
        equal = all(v == f32["one device"] for v in f32.values())
        log(f"[compare f32] L=4 full width, the first 4 requests' "
            f"{'paged' if paged else 'contiguous'} streams through PPBackend "
            f"({', '.join(list(f32)[1:])}) == single device: {equal}")
        same &= equal
    if not same:
        raise AssertionError("f32 PP streams differ across depths or from "
                             "the single-device path")
    del p32

    # (e) one decode round's time breakdown
    log(f"[pp phase] (a)-(d) in {time.perf_counter() - t_phase:.1f} s")
    for kind, t, p, d in PP_BREAKDOWN:
        pp_round_breakdown(dev, smi, cfg, params, kind, t, p, d)
    log(f"[pp phase] {time.perf_counter() - t_phase:.1f} s")
    return totals


def pp_round_breakdown(dev, smi, cfg, params, kind: str, t: int, p: int,
                       d: int, rounds: int = 4):
    """One decode round of all 4 slots at pos ~130 through a backend of
    ``kind`` and its queue (d group rounds begun together and drained), as
    the Scheduler drives it: host wall (synchronised, no profiler), device
    busy (``device_busy_us``), idle share, and on the pipeline the
    boundary hops' device time: the device records launched inside
    ``send_boundary`` (the profiler's device time of the host-side range,
    which leaves out the gaps between the copies that the range's span on
    the card holds)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.runtime.backends import make_backend

    backend = make_backend(kind, cfg, params, num_slots=4, max_len=1024, t=t,
                           p=p, inflight=d, device=dev)
    prompts = torch.randint(2, cfg.vocab_size, (4, 128),
                            generator=torch.Generator().manual_seed(5))
    state = {"tok": backend.prefill_into_slots(list(prompts.numpy()),
                                               range(4)),
             "pos": np.full(4, 128)}
    queue = backend.make_queue()
    if p > 1:
        send = backend.engine.send_boundary

        def hop(*args, **kw):
            with record_function(RANGES[0]):
                return send(*args, **kw)
        backend.engine.send_boundary = hop

    def run(n):
        for _ in range(n):
            for g in range(d):
                queue.begin_round(g, state["tok"], state["pos"])
            for res in queue.sync():
                state["tok"][res.slots] = res.tokens
            state["pos"] = state["pos"] + 1

    run(2)                                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(rounds)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / rounds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(rounds)
        torch.cuda.synchronize()
    busy_us, summed_us = device_busy_us(prof)
    what = f"{kind} t={t} p={p} inflight={d}"
    if busy_us <= 0:
        log(f"[round {what}] 4 slots: host wall {wall_ms:.3f} ms/round; "
            "device busy: not measured (profiler recorded no device time)")
        return
    hops = [e for e in prof.events() if e.name == RANGES[0]]
    hop_us = sum(e.device_time_total for e in hops if not _on_card(e))
    span_us = sum(e.time_range.elapsed_us() for e in hops if _on_card(e))
    busy_ms = busy_us / 1e3 / rounds
    hop_txt = (f"{hop_us / 1e3 / rounds:.4f} ms/round (the range's span on "
               f"the card {span_us / 1e3 / rounds:.4f})" if hop_us > 0 else
               "not measured (no device time under the hop)")
    hop_txt += (f" ({(p - 1) * 2 * d} copies of [{4 // d}, 1, "
                f"{cfg.d_model // t}] x {t} ranks)")
    if p == 1:
        hop_txt = "none (one stage)"
    log(f"[round {what}] 4 slots at pos ~130: host wall {wall_ms:.3f} "
        f"ms/round (no profiler), device busy {busy_ms:.3f} ms/round "
        f"(profiler, union of kernel intervals; their sum "
        f"{summed_us / 1e3 / rounds:.3f}), device idle share "
        f"{1 - busy_ms / wall_ms:.3f}, boundary hops' device time "
        f"{hop_txt} ({smi})")
    del backend


# ---------------------------------------------------------------------------
# phase 8: context parallelism on virtual CP workers, full width
# ---------------------------------------------------------------------------

CP_LAYOUTS = ((1, 2, 1), (2, 2, 1), (1, 2, 2), (2, 2, 2))    # (t, c, p)
# (e): (t, c, p, paged) over the smoke trace, 4 slots
CP_SERVE = ((1, 2, 1, False), (2, 2, 1, True), (1, 2, 2, False))
CP_TIME_S = 2048        # (f): one prompt of this length at t = 1
CP_TIME_C = (1, 2, 4)


class PipelineAsModel:
    """A ``PipelineEngine`` behind ``Model``'s prefill / decode_step /
    decode_steps on its staged parameters; the prefill pads to a multiple
    of c and runs the CP stages."""

    def __init__(self, eng):
        self.eng, self.cfg = eng, eng.cfg

    def prefill(self, staged, tokens, max_len: int):
        from repro_torch.core.parallel_exec import pad_to_multiple
        S = tokens.shape[1]
        logits, caches = self.eng.prefill_with_cache(
            staged, pad_to_multiple(tokens, self.eng.c),
            self.eng.cache_width(max_len), S - 1)
        return logits, caches, S

    def decode_step(self, staged, caches, tokens, pos):
        return self.eng.decode_once(staged, caches, tokens, pos)

    def decode_steps(self, staged, caches, tokens, pos, n: int):
        return self.eng.generate(staged, caches, tokens, pos, n)


def cp_model(cfg, params, t: int, c: int, p: int, dev, shards=None):
    """(model, its parameters) of a (t, c, p) layout: ``TPModel`` at p = 1,
    ``PipelineAsModel`` over ``PipelineEngine`` otherwise."""
    from repro_torch.core.parallel_exec import (PipelineEngine, TPModel,
                                                shard_params)
    if p == 1:
        return TPModel(cfg, t, c=c), (shards if shards is not None
                                      else shard_params(cfg, params, t))
    eng = PipelineEngine(cfg, t=t, p=p, c=c, device=dev)
    return PipelineAsModel(eng), eng.prepare(params)


def first_divergence(a, b) -> str:
    """The first column where two [B, n] token tensors differ, or none."""
    diff = (a != b).any(dim=0).nonzero()
    return "none" if diff.numel() == 0 else str(int(diff[0]))


def cp_phase(dev, smi, params, prompt, kernel_rows):
    """Phase 8: (b) CP parity against the c = 1 path of the same (t, p),
    the ring bitwise, bf16 teacher-forced within the kernel-path limits,
    f32 greedy tokens at L = 4; (c) the comm logs against the closed
    forms; (d) the launch formulas, no plain attention; (e) the three
    backends through the Scheduler; (f) one 2048-token prefill at
    c = 1, 2, 4."""
    from repro_torch.core import comm
    from repro_torch.core.commodel import comm_ops_for, cp_comm_ops
    from repro_torch.core.parallel_exec import TPModel, shard_params
    from repro_torch.kernels import _build
    from repro_torch.models import blocks, layers
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime.backends import make_backend
    from repro_torch.runtime.scheduler import Scheduler

    cfg = llama_config()
    L = cfg.num_layers
    b = torch_dtype(cfg.dtype).itemsize
    totals = {name: 0 for name in _build.LAUNCHES}
    t_phase = time.perf_counter()
    prompts = [torch.as_tensor(r.prompt, dtype=torch.int32, device=dev)[None]
               for r in smoke_trace(cfg)[:PP_PROMPTS]]
    shards = {1: shard_params(cfg, params, 1), 2: shard_params(cfg, params, 2)}

    # every ring assembly checked bitwise; the plain attention counted
    ring, gqa = layers.ring_kv_assemble, blocks.gqa_attention
    rings, plain_calls = [], []

    def checked(parts, group):
        full = ring(parts, group)
        want = torch.cat(parts, dim=1)
        rings.append(all(torch.equal(f, want) for f in full))
        return full

    def counted(*a):
        plain_calls.append(1)
        return gqa(*a)

    layers.ring_kv_assemble, blocks.gqa_attention = checked, counted
    try:
        for t, c, p in CP_LAYOUTS:
            what = f"cp t={t} c={c} p={p}"
            t_layout = time.perf_counter()
            model, mp = cp_model(cfg, params, t, c, p, dev, shards.get(t))
            ref, ref_params = ((get_model(cfg), params) if t == 1 else
                               (TPModel(cfg, t), shards[t]))
            diffs, same, first = [], 0, []
            for i, x in enumerate(prompts):
                S = x.shape[1]
                logs = ([model.group] if p == 1 else
                        [m.group for m in model.eng.stages])
                for g in logs:
                    g.log.clear()
                if p > 1:
                    model.eng.transfers.clear()
                got = drive_counted(
                    f"{what} S={S} engine", lambda: pp_greedy(
                        x, PP_NEW, lambda y: model.prefill(mp, y, 1024)[:2],
                        lambda *a: model.decode_steps(mp, *a),
                        lambda *a: model.decode_step(mp, *a)),
                    totals, L, passes=PP_NEW, flash=0, decode=PP_NEW,
                    paged=0, t=t, p=p, cp=1, c=c)
                with torch.inference_mode():
                    want = pp_greedy(
                        x, PP_NEW, lambda y: ref.prefill(ref_params, y,
                                                         1024)[:2],
                        lambda *a: ref.decode_steps(ref_params, *a),
                        lambda *a: ref.decode_step(ref_params, *a))
                diffs.append(float((got[0].float() - want[0].float())
                                   .abs().max()))
                same += int(torch.equal(got[1], want[1]))
                first.append(first_divergence(got[1], want[1]))
                # (c) the logs: prefill rows with the ring, decode rows c=1's
                ops = comm_ops_for(cfg, S, PP_NEW + 1, t, p, c=c, b=b,
                                   gather_mode="allgather")
                c1 = comm_ops_for(cfg, S, PP_NEW + 1, t, p, b=b,
                                  gather_mode="allgather")
                dec = [o for o in ops if o.phase == "decode"]
                if dec != [o for o in c1 if o.phase == "decode"]:
                    raise AssertionError(f"{what}: decode rows depend on c")
                if p == 1:
                    got_log = model.group.summary()
                    if comm.fold(got_log) != comm.fold(ops):
                        raise AssertionError(
                            f"{what} S={S}: logged {got_log} != {ops}")
                    if t == 1 and comm.fold(model.group.summary(
                            "prefill")) != comm.fold(cp_comm_ops(
                                cfg, S, c, b=b)):
                        raise AssertionError(f"{what}: CP log != "
                                             "cp_comm_ops")
                    continue
                pp_check_stage_logs(f"{what} S={S}", model.eng, cfg, t, p,
                                    {"prefill": 1, "decode": PP_NEW}, c=c)
                for phase in ("prefill", "decode"):
                    row = [o for o in ops if o.collective == "send"
                           and o.phase == phase][0]
                    summ = model.eng.transfer_summary(phase)
                    if summ != {"count": row.count,
                                "bytes": row.total_msg_bytes}:
                        raise AssertionError(
                            f"{what} S={S} {phase} transfers {summ} != "
                            f"{row.count} x {row.total_msg_bytes} bytes")
            log(f"[cp parity] {what} bf16, {len(prompts)} prompts of the "
                f"trace, prefill + {PP_NEW} greedy tokens against the c = 1 "
                f"path ({'Model' if t == 1 else 'TPModel t=2'}): prefill "
                f"logits max |diff| {[round(d, 4) for d in diffs]}, tokens "
                f"identical {same}/{len(prompts)}, first diverging position "
                f"{first}; "
                + ("every stage's log == hybrid_stage_collectives(c=2), "
                   "transfers == the send rows" if p > 1 else
                   f"comm log == comm_ops_for(c={c})"
                   + (" and cp_comm_ops" if t == 1 else ""))
                + " of every prompt; decode rows == c = 1's")
            # bf16 teacher-forced against the c = 1 path
            base = kernel_rows if t == 1 else teacher_forced(
                ref, ref_params, prompt, False)
            hold(f"bf16 CP {what} (CP prefill of {SPLIT}) vs c = 1 "
                 f"({'Model' if t == 1 else 'TPModel t=2'})",
                 teacher_forced(model, mp, prompt, False), base,
                 LOGIT_MATCH_FLOOR, LOGIT_DRIFT_CEILING)
            log(f"[cp parity] {what} in "
                f"{time.perf_counter() - t_layout:.1f} s")
            del model, mp, ref, ref_params
        if not (rings and all(rings)):
            raise AssertionError("a ring-assembled K/V differs from its "
                                 "shards' blocks")
        log(f"[cp ring] {len(rings)} ring assemblies, every worker's K/V "
            f"bitwise its shards' blocks in order")

        # f32 at L = 4: greedy tokens identical (odd prompts, padded)
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg32 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
        p32 = get_model(cfg32).init(seed=3, device=dev)
        x32 = torch.randint(2, cfg.vocab_size, (2, 127),
                            generator=torch.Generator().manual_seed(4)).to(dev)
        same, t_f32 = {}, time.perf_counter()
        for t, c, p in CP_LAYOUTS:
            ref, ref_params = pp_reference(cfg32, p32, t)
            want = tp_greedy(ref, ref_params, x32, 256, 32)
            model, mp = cp_model(cfg32, p32, t, c, p, dev)
            same[(t, c, p)] = bool(torch.equal(
                tp_greedy(model, mp, x32, 256, 32), want))
            del model, mp
        log(f"[compare f32] L=4 full width, 2 prompts of 127 tokens (padded "
            f"to 128), greedy 32 tokens CP == c = 1 path: {same} in "
            f"{time.perf_counter() - t_f32:.1f} s")
        if not all(same.values()):
            raise AssertionError("f32 CP greedy tokens differ from c = 1")
        del p32

        # (e) serving through the Scheduler, beside the single device's
        # streams over the same requests
        backend = make_backend("gspmd", cfg, params, num_slots=4,
                               max_len=1024, device=dev)
        streams_c1 = Scheduler(backend).run(
            smoke_trace(cfg)[:SERVE_REQUESTS]).tokens_by_rid()
        del backend
        for t, c, p, paged in CP_SERVE:
            kind = "pp" if p > 1 else "tp"
            what = (f"cp t={t} c={c} p={p} "
                    f"{'paged' if paged else 'contiguous'}")
            kw = dict(paged=True, page_size=16) if paged else {}
            runs = [(what, dict(c=c), True)]
            if paged:
                runs.append((f"t={t} c=1 paged", dict(c=1), False))
            streams = {}
            for name, ckw, is_cp in runs:
                trace = smoke_trace(cfg)[:SERVE_REQUESTS]
                backend = make_backend(kind, cfg, params, num_slots=4,
                                       max_len=1024, t=t, p=p, device=dev,
                                       **ckw, **kw)
                _build.reset_launches()
                t0 = time.perf_counter()
                report = Scheduler(backend).run(trace)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = dict(_build.LAUNCHES)
                require_all_finished(name, trace, report)
                n_dec = sum(1 for r in report.steps if r.phase == "decode")
                n_pre = len(trace)
                expect_launches(name, counts, L,
                                passes=n_dec + (0 if is_cp else n_pre),
                                flash=0 if is_cp else n_pre,
                                decode=0 if paged else n_dec,
                                paged=n_dec if paged else 0, t=t, p=p,
                                cp=n_pre if is_cp else 0, c=c)
                for k in totals:
                    totals[k] += counts[k]
                if is_cp and kind == "tp":
                    got = comm.fold(backend.model.group.summary("prefill"))
                    want = collections.Counter()
                    for r in trace:
                        want.update(comm.fold(
                            backend.prefill_comm_ops(r.prompt_len)))
                    if got != dict(want):
                        raise AssertionError(f"{name}: prefill log {got} != "
                                             f"{dict(want)}")
                if is_cp and kind == "pp":
                    pp_check_stage_logs(name, backend.engine, cfg, t, p,
                                        {"prefill": n_pre, "decode": n_dec},
                                        c=c)
                streams[name] = report.tokens_by_rid()
                log(f"[cp serve {name}] {len(report.metrics)} requests, "
                    f"{report.total_tokens} tokens, {n_dec} decode steps in "
                    f"{wall:.2f} s, {report.total_tokens / wall:.1f} tokens/s "
                    f"({smi})")
                del backend
            ref_streams = streams[runs[1][0]] if paged else streams_c1
            equal = sum(streams[what][r] == ref_streams[r]
                        for r in streams[what])
            log(f"[cp serve {what}] streams equal to the c = 1 backend's "
                f"({'TP t=2 paged' if paged else 'single device'}): "
                f"{equal}/{len(streams[what])} (bf16)")
        if plain_calls:
            raise AssertionError(f"{len(plain_calls)} plain attention calls "
                                 "on the card")
        log("[cp] plain attention calls on the card: 0")
    finally:
        layers.ring_kv_assemble, blocks.gqa_attention = ring, gqa
    del shards[2]
    log(f"[cp phase] (b)-(e) in {time.perf_counter() - t_phase:.1f} s")
    cp_prefill_breakdown(dev, smi, cfg, shards[1])
    log(f"[cp phase] {time.perf_counter() - t_phase:.1f} s")
    return totals


def cp_prefill_breakdown(dev, smi, cfg, shards):
    """Phase 8(f): one CP_TIME_S-token prompt at t = 1 and c = 1, 2, 4 on
    the card, the c workers in series: host wall (synchronised, no
    profiler), device busy (``device_busy_us``), B2's device ms, the ring's
    device ms (the records under ``layers.ring_kv_assemble``) and bytes
    against ``commodel.v_cp``, beside ``slo.predict_slo``'s TTFT, a model
    of c cards."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core.commodel import cp_comm_ops, v_cp
    from repro_torch.core.parallel_exec import TPModel
    from repro_torch.core.slo import predict_slo
    from repro_torch.models import layers

    S, L = CP_TIME_S, cfg.num_layers
    prompt = torch.randint(2, cfg.vocab_size, (1, S), device=dev,
                           generator=torch.Generator(dev).manual_seed(13))
    ring = layers.ring_kv_assemble

    def ranged(parts, group):
        with record_function(RANGES[1]):
            return ring(parts, group)

    layers.ring_kv_assemble = ranged
    try:
        for c in CP_TIME_C:
            model = TPModel(cfg, 1, c=c)

            def run():
                return model.cp_prefill(shards, prompt, S - 1, S)

            with torch.inference_mode():
                run()                                        # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    run()
                    torch.cuda.synchronize()
            busy_us, summed_us = device_busy_us(prof)
            events = device_events(prof)
            b2_ms = sum(e.self_device_time_total for e in events
                        if "flash_prefill" in e.key) / 1e3
            rng = [e for e in prof.events() if e.name == RANGES[1]]
            ring_ms = sum(e.device_time_total for e in rng
                          if not _on_card(e)) / 1e3
            block = S // c * cfg.num_kv_heads * cfg.head_dim * 2
            # each worker's own rows, then the c(c-1) hops; no ring at c = 1
            moved = 2 * L * c * c * block if c > 1 else 0
            wire = 2 * L * c * (c - 1) * block
            per_worker = sum(o.total_msg_bytes for o in cp_comm_ops(
                cfg, S, c) if o.collective == "collectivepermute")
            ttft = predict_slo(cfg, S, 1, t=1, c=c).ttft * 1e3
            busy_ms = busy_us / 1e3
            log(f"[cp prefill] {cfg.name} S={S}, t=1 c={c} (the c workers in "
                f"series on one card): host wall {wall_ms:.3f} ms (no "
                f"profiler), device busy {busy_ms:.3f} ms (profiler, union; "
                f"sum {summed_us / 1e3:.3f}), device idle share "
                f"{1 - busy_ms / wall_ms:.3f}, B2 {b2_ms:.3f} ms, ring "
                f"copies {ring_ms:.3f} ms device for {moved} bytes "
                f"({2 * L * c * c if c > 1 else 0} copies of [{S // c}, "
                f"{cfg.num_kv_heads * cfg.head_dim}] bf16; the hops "
                f"{wire} bytes = c x the per-worker ring volume "
                f"{per_worker}, v_cp {v_cp(cfg, S, c):.0f}); "
                f"slo.predict_slo TTFT {ttft:.3f} ms (a model of {c} "
                f"H100 cards, not this run) ({smi})")
            for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
                log(f"    device {e.self_device_time_total / 1e3:8.3f} ms "
                    f"{e.count:5d}x  {e.key[:90]}")
            del model
    finally:
        layers.ring_kv_assemble = ring


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 9: failure semantics, the prefix cache and disaggregated pools
# ---------------------------------------------------------------------------

FAIL_SLOTS, FAIL_PAGES = 3, 21          # 20 usable pages: oversubscribed
FAIL_LENS = ((96, 48), (160, 40), (64, 56), (128, 32), (112, 64),
             (80, 60))                  # (prompt, new tokens)
DISAGG_ROUTE = 512                      # prompts of 512+ tokens hand off
HANDOFF_PAGES = 64                      # pages timed in (d)


def prefix_trace(cfg):
    """(a)'s trace: 8 requests on 2 templates of 256 tokens (16 pages)
    with suffixes of 16–128 tokens and 16–64 new tokens, all arriving at
    once, and the first template alone: a fully cached prompt, whose hit
    is capped one position short, its last page copied on write and its
    suffix one token (B4, not B2)."""
    from repro_torch.runtime.request import Request, make_template_trace
    reqs = make_template_trace(8, 0, cfg.vocab_size, n_templates=2,
                               template_len=256, suffix_lens=(16, 128),
                               decode_lens=(16, 64), seed=5)
    reqs.append(Request(rid=8, prompt=reqs[0].prompt[:256].copy(),
                        max_new_tokens=16))
    return reqs


def fail_trace(cfg, seed: int = 6):
    """(b)'s and (c)'s trace: 6 requests whose worst cases (9, 13, 8, 10,
    11 and 9 pages of 16) overrun the 20-page pool under optimistic
    admission."""
    from repro_torch.runtime.request import Request
    g = torch.Generator().manual_seed(seed)
    return [Request(rid=i, prompt=torch.randint(
        2, cfg.vocab_size, (s,), generator=g).to(torch.int32).numpy(),
        max_new_tokens=n) for i, (s, n) in enumerate(FAIL_LENS)]


def disagg_trace(cfg, seed: int = 7):
    """(d)'s trace: 4 prompts of 512–1024 tokens (the prefill pool's) and
    4 of 64–256 (straight to the decode pool), 16–32 new tokens each."""
    from repro_torch.runtime.request import Request
    g = torch.Generator().manual_seed(seed)
    lens = (1024, 96, 700, 256, 512, 64, 833, 180)
    return [Request(rid=i, prompt=torch.randint(
        2, cfg.vocab_size, (s,), generator=g).to(torch.int32).numpy(),
        max_new_tokens=16 + (5 * i) % 17) for i, s in enumerate(lens)]


def count_into(totals):
    """A context for one counted run: launch counts reset on entry and
    added to ``totals`` on exit (the counts of the run, ``dict``)."""
    import contextlib
    from repro_torch.kernels import _build

    @contextlib.contextmanager
    def run():
        _build.reset_launches()
        counts = {}
        yield counts
        torch.cuda.synchronize()
        counts.update(_build.LAUNCHES)
        for k in totals:
            totals[k] += counts[k]
    return run()


def require_drained(what, backend):
    """Raise unless the pool holds nothing once the index lets go."""
    if backend.prefix_index is not None:
        backend.prefix_index.clear()
    pool = backend.pool
    if pool.owners() or pool.free_pages != pool.num_pages - 1:
        raise AssertionError(f"{what}: pages leaked ({pool.stats()})")


def agreement_scheduler():
    """A Scheduler that records whether each recompute pass's token equals
    the stream's and goes on with the stream's, where the scheduler's own
    check raises: (c) measures bf16, it does not hold it."""
    from repro_torch.runtime.scheduler import Scheduler

    class Measured(Scheduler):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.agree = []

        def _resume_active(self, slot, req, m, resume, prefix_len, tok):
            self.agree.append(tok == resume[-1])
            super()._resume_active(slot, req, m, resume, prefix_len,
                                   resume[-1])
    return Measured


def disagg_scheduler():
    """A DisaggScheduler that keeps the prefill pool's first tokens aside
    instead of asserting them against the decode pool's: (d)'s bf16 runs
    measure the cross-pool agreement, the f32 run holds it."""
    from repro_torch.runtime.scheduler import DisaggScheduler

    class Measured(DisaggScheduler):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.first = {}

        def _prefill_one(self, req):
            done = super()._prefill_one(req)
            self.first.update(self._expected_first)
            self._expected_first.clear()
            return done
    return Measured


def prefix_cache_run(dev, smi, cfg, params, totals):
    """(a): the template trace on the paged Scheduler (4 slots, chunk
    256) with the prefix cache off and on; the hits, the copy-on-writes
    replayed, no leak, the launch formula (a warm chunk L B2, a one-token
    suffix L B4 pairs), streams against cold; then the trace's prefill
    work alone, cold and warm: host wall and device busy."""
    from repro_torch.runtime.backends import make_backend
    from repro_torch.runtime.scheduler import Scheduler

    L, ps = cfg.num_layers, 16
    streams = {}
    for cached in (False, True):
        what = f"prefix cache {'on' if cached else 'off'}"
        trace = prefix_trace(cfg)
        backend = make_backend("gspmd", cfg, params, num_slots=4,
                               max_len=1024, paged=True, page_size=ps,
                               prefix_cache=cached, device=dev)
        sizes, cows = [], []
        chunk, copy = backend.prefill_chunk, backend._copy_page

        def sized(slot, tokens, start, chunk=chunk):
            sizes.append(len(tokens))
            return chunk(slot, tokens, start)

        def copied(src, dst, copy=copy):
            cows.append((src, dst))
            return copy(src, dst)
        backend.prefill_chunk, backend._copy_page = sized, copied
        t0 = time.perf_counter()
        with count_into(totals) as counts:
            report = Scheduler(backend, chunk_size=256).run(trace)
        wall = time.perf_counter() - t0
        require_all_finished(what, trace, report)
        n_dec = sum(1 for r in report.steps if r.phase == "decode")
        ones = sum(1 for s in sizes if s == 1)
        expect_launches(what, counts, L, passes=len(sizes) + n_dec,
                        flash=len(sizes) - ones, decode=0,
                        paged=n_dec + ones)
        hits = {m.rid: m.cached_prefix_len for m in report.metrics}
        cow_copies = backend.pool.stats().cow_copies
        if len(cows) != cow_copies:
            raise AssertionError(f"{what}: {cow_copies} copy-on-writes, "
                                 f"{len(cows)} replayed on the card")
        if cached:
            lens = {r.rid: r.prompt_len for r in trace}
            bad = [r for r, h in hits.items() if h > lens[r] - 1 or
                   (h % ps and h != lens[r] - 1)]
            if bad or hits[8] != 255 or ones != 1 or not cows or \
                    sum(1 for h in hits.values() if h) < 4:
                raise AssertionError(
                    f"{what}: hits {hits}, one-token suffixes {ones}, "
                    f"copy-on-writes {cows}")
        elif any(hits.values()) or cows:
            raise AssertionError(f"{what}: hits {hits}, copies {cows}")
        require_drained(what, backend)
        streams[cached] = report.tokens_by_rid()
        log(f"[prefix {what}] {len(trace)} requests, "
            f"{report.total_tokens} tokens, {len(sizes)} prefill chunks "
            f"({ones} of one token), {n_dec} decode steps, hits {hits}, "
            f"{len(cows)} copy-on-writes, in {wall:.2f} s ({smi})")
        del backend
    same = sum(streams[True][r] == streams[False][r] for r in streams[False])
    log(f"[prefix] warm streams equal to cold: {same}/{len(streams[False])} "
        f"(bf16)")
    prefill_work(dev, smi, cfg, params)


def prefill_work(dev, smi, cfg, params):
    """The template trace's prefills alone, one after another in slot 0:
    cold (every prompt whole) and warm (both templates indexed first;
    each prompt adopts its template's pages and prefills its suffix).
    Host wall (synchronised, no profiler) and device busy (the union of
    the profiler's kernel records, ``device_busy_us``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.backends import make_backend

    trace = prefix_trace(cfg)
    prompts = [r.prompt for r in trace]
    out = {}
    for cached in (False, True):
        be = make_backend("gspmd", cfg, params, num_slots=1, max_len=1024,
                          paged=True, page_size=16, prefix_cache=cached,
                          device=dev)
        if cached:
            for tmpl in {p[:256].tobytes(): p[:256] for p in prompts}.values():
                be.begin_prefill(0, len(tmpl), 1)
                be.prefill_whole(0, tmpl)
                be.cache_prefix(0, tmpl)
                be.free_slots([0])
        hits = []

        def work():
            hits.clear()
            for p in prompts:
                hit = be.begin_prefill_cached(0, p, 1)
                be.prefill_whole(0, p, start=hit)
                be.free_slots([0])
                hits.append(hit)
        walls = []
        with torch.inference_mode():
            work()                                           # warm-up
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                work()
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
            wall_ms = sorted(walls)[1]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                work()
                torch.cuda.synchronize()
        busy_us, _ = device_busy_us(prof)
        computed = sum(len(p) - h for p, h in zip(prompts, hits))
        out[cached] = (wall_ms, busy_us / 1e3)
        log(f"[prefix prefill {'warm' if cached else 'cold'}] "
            f"{len(prompts)} prompts, {computed} of "
            f"{sum(len(p) for p in prompts)} positions computed: host wall "
            f"{wall_ms:.3f} ms (median of "
            f"{', '.join(f'{w:.3f}' for w in walls)}), device busy "
            f"{busy_us / 1e3:.3f} ms, idle "
            f"share {1 - busy_us / 1e3 / wall_ms:.3f} ({smi})")
        require_drained("prefill work", be)
        del be
    log(f"[prefix prefill] warm / cold: host wall "
        f"{out[True][0] / out[False][0]:.3f}, device busy "
        f"{out[True][1] / max(out[False][1], 1e-9):.3f}")


def failure_f32_run(dev, smi, cfg, totals):
    """(b), f32 at L = 4, full width: optimistic admission on an
    oversubscribed pool preempts (gspmd and TP t = 2), the scheduler's
    token-identity check holds and the streams equal a conservative
    run's; the recompute rows equal ``preemption_recompute_ops``;
    scripted transient faults at every site (PP (1, 2), which draws
    pp_transfer) are retried and the streams equal the fault-free ones;
    a deadline and a cancel finish with their reasons."""
    from repro_torch.core.commodel import preemption_recompute_ops
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime.backends import make_backend
    from repro_torch.runtime.faults import Fault, FaultInjector
    from repro_torch.runtime.scheduler import (Scheduler, VirtualClock,
                                               _count)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    p32 = get_model(cfg32).init(seed=5, device=dev)
    kw = dict(num_slots=FAIL_SLOTS, max_len=1024, paged=True, page_size=16,
              device=dev)
    with count_into(totals):
        ref = Scheduler(make_backend("gspmd", cfg32, p32, **kw)).run(
            fail_trace(cfg32)).tokens_by_rid()
    for kind, t in (("gspmd", 1), ("tp", 2)):
        what = f"f32 L=4 optimistic {kind} t={t}"
        backend = make_backend(kind, cfg32, p32, t=t, num_pages=FAIL_PAGES,
                               **kw)
        with count_into(totals):
            report = Scheduler(backend, admission="optimistic").run(
                fail_trace(cfg32))
        recs = [r for r in report.steps if r.phase == "recompute"]
        wrong = [r.prefix_len for r in recs if r.collective_counts != _count(
            preemption_recompute_ops(cfg32, r.prefix_len, t, b=4,
                                     gather_mode="allgather"))]
        if report.preemptions < 1 or len(recs) != report.preemptions or \
                wrong or report.tokens_by_rid() != ref:
            raise AssertionError(
                f"{what}: {report.preemptions} preemptions, {len(recs)} "
                f"recompute rows, rows off the closed form at {wrong}, "
                f"streams equal: {report.tokens_by_rid() == ref}")
        require_drained(what, backend)
        log(f"[fail] {what}: {report.preemptions} preemptions, recompute "
            f"rows {[(r.prefix_len, r.collective_counts) for r in recs]} "
            f"== preemption_recompute_ops, streams == conservative run")
    plan = {("decode", 2): "transient", ("prefill", 1): "transient",
            ("pool", 3): "oom", ("pp_transfer", 4): "transient"}
    inj = FaultInjector.scripted({k: Fault(k[0], v) for k, v in plan.items()})
    backend = make_backend("pp", cfg32, p32, t=1, p=2, **kw)
    clock = VirtualClock()
    with count_into(totals):
        report = Scheduler(backend, clock=clock, faults=inj,
                           retry_backoff=0.01).run(fail_trace(cfg32))
    if len(inj.injected) != len(plan) or report.retries < 3 or \
            report.preemptions != 1 or report.tokens_by_rid() != ref:
        raise AssertionError(
            f"faults: {inj.injected} injected, {report.retries} retries, "
            f"{report.preemptions} preemptions, streams equal: "
            f"{report.tokens_by_rid() == ref}")
    require_drained("faults", backend)
    log(f"[fail] f32 L=4 pp (1, 2): transient faults at decode, prefill, "
        f"pp_transfer and a pool exhaustion absorbed: {report.retries} "
        f"retries, 1 preemption, {clock.now():.2f} s of backoff on the "
        f"virtual clock, streams == fault-free run")
    reqs = fail_trace(cfg32)
    reqs[3].ttft_deadline = 0.5                # queued when it expires
    backend = make_backend("gspmd", cfg32, p32, **kw)
    clock = VirtualClock()
    sched = Scheduler(backend, clock=clock)
    with count_into(totals):
        sched.submit(reqs)
        for _ in range(3):
            sched.step()
        cancelled = sched.cancel(0)            # decoding
        clock.advance(1.0)
        report = sched.run()
    by = {m.rid: m for m in report.metrics}
    if not cancelled or by[0].finish_reason != "cancelled" or \
            by[3].finish_reason != "deadline" or by[3].tokens or \
            by[0].tokens != ref[0][:by[0].num_generated] or \
            by[1].tokens != ref[1] or by[2].tokens != ref[2]:
        raise AssertionError("deadline/cancel: " + str(
            [(m.rid, m.finish_reason) for m in report.metrics]))
    require_drained("deadline/cancel", backend)
    log(f"[fail] cancel of a decoding request after "
        f"{by[0].num_generated} tokens: cancelled, its stream a prefix of "
        f"the reference; a TTFT deadline shed a queued request")
    del p32
    return cfg32


def recompute_agreement_bf16(dev, smi, cfg, params, totals):
    """(c): (b)'s preemption trace in bf16 at LLAMA_DEPTH, measured and not
    held: the share of recompute passes whose token equals the token the
    request decoded step by step."""
    from repro_torch.runtime.backends import make_backend
    backend = make_backend("gspmd", cfg, params, num_slots=FAIL_SLOTS,
                           max_len=1024, paged=True, page_size=16,
                           num_pages=FAIL_PAGES, device=dev)
    sched = agreement_scheduler()(backend, admission="optimistic")
    with count_into(totals):
        report = sched.run(fail_trace(cfg))
    require_drained("bf16 recompute", backend)
    agree = sum(sched.agree)
    log(f"[fail bf16] L={cfg.num_layers}, optimistic: {report.preemptions} "
        f"preemptions; recompute token == stream token on {agree}/"
        f"{len(sched.agree)} ({agree / max(len(sched.agree), 1):.3f}; "
        f"measured, not held) ({smi})")
    if not sched.agree:
        raise AssertionError("bf16 recompute: no preemption")
    return agree, len(sched.agree)


def disagg_pools(cfg, params, dev, kind, t, dec_slots=4):
    """A decode pool (paged, prefix cache) and a prefill pool that shares
    its KVPool under the owner ids past the decode pool's slots."""
    from repro_torch.runtime.backends import make_backend
    kw = dict(max_len=2048, paged=True, page_size=16, t=t, device=dev)
    dec = make_backend(kind, cfg, params, num_slots=dec_slots,
                       num_pages=1 + (dec_slots + 1) * 128,
                       prefix_cache=True, **kw)
    pre = make_backend(kind, cfg, params, num_slots=1, pool=dec.pool,
                       owner_base=dec_slots, **kw)
    return pre, dec


def handoff_timing(dev, smi, cfg, pre, dec, pages):
    """Export (device to host) and import (host to device) of ``pages``
    K/V pages, one page at a time, synchronised: ms per page and GB/s,
    beside ``predict_slo``'s handoff term at ``H100_NODE.inter_bw``."""
    from repro_torch.config.base import H100_NODE
    from repro_torch.core.commodel import kv_page_bytes
    from repro_torch.core.slo import predict_slo
    from repro_torch.models.layers import torch_dtype
    nbytes = kv_page_bytes(cfg, 16, b=torch_dtype(cfg.dtype).itemsize)
    for pg in pages[:4]:                        # warm-up
        dec.import_page(pg, pre.export_page(pg))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = [pre.export_page(pg) for pg in pages]
    t1 = time.perf_counter()
    landed = sum(dec.import_page(pg, r) for pg, r in zip(pages, rows))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if landed != nbytes * len(pages):
        raise AssertionError(f"handoff: {landed} bytes landed, "
                             f"{nbytes * len(pages)} exported")
    exp_ms, imp_ms = 1e3 * (t1 - t0) / len(pages), 1e3 * (t2 - t1) / len(pages)
    # the same rows into pinned host buffers (not the port's path): how
    # much of the export is the pageable copy
    pools = pre._page_pools()
    pinned = [{key: torch.empty(pl[key][:, 0].shape, dtype=pl[key].dtype,
                                pin_memory=torch.cuda.is_available())
               for key in ("k", "v")}
              for _, pl in pools]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    for pg in pages:
        for (_, pl), buf in zip(pools, pinned):
            for key in ("k", "v"):
                buf[key].copy_(pl[key][:, pg])
    torch.cuda.synchronize()
    pin_ms = 1e3 * (time.perf_counter() - t3) / len(pages)
    model_ms = 1e3 * predict_slo(cfg, 1024, 16, handoff_pages=1,
                                 page_size=16).breakdown["handoff_s"]
    log(f"[disagg handoff] {len(pages)} pages of {nbytes} B: export "
        f"(D2H) {exp_ms:.4f} ms/page {nbytes / exp_ms / 1e6:.2f} GB/s, "
        f"import (H2D) {imp_ms:.4f} ms/page {nbytes / imp_ms / 1e6:.2f} "
        f"GB/s, both {exp_ms + imp_ms:.4f} ms/page; D2H into pinned "
        f"buffers {pin_ms:.4f} ms/page {nbytes / pin_ms / 1e6:.2f} GB/s; "
        f"predict_slo's handoff "
        f"term {model_ms:.4f} ms for one page at inter_bw "
        f"{H100_NODE.inter_bw / 1e9:.0f} GB/s + inter_alpha "
        f"{H100_NODE.inter_alpha * 1e6:.0f} us ({smi})")


def disagg_run(dev, smi, cfg, params, cfg32, totals):
    """(d): DisaggScheduler on one card, gspmd pools and TP t = 2 pools.
    bf16 at LLAMA_DEPTH: every handoff's bytes equal kv_handoff_ops (the
    scheduler raises otherwise), the handoff timed per page, the
    cross-pool first-token agreement measured; f32 at L = 4 end to end
    with the scheduler's cross-pool identity check, streams against the
    colocated backend's."""
    from repro_torch.core.commodel import kv_handoff_pages, kv_page_bytes
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime.backends import make_backend
    from repro_torch.runtime.scheduler import DisaggScheduler, Scheduler

    page_bytes = kv_page_bytes(cfg, 16, b=torch_dtype(cfg.dtype).itemsize)
    for kind, t in (("gspmd", 1), ("tp", 2)):
        what = f"disagg {kind} t={t} bf16"
        trace = disagg_trace(cfg)
        pre, dec = disagg_pools(cfg, params, dev, kind, t)
        sched = disagg_scheduler()(pre, dec, route_prompt_len=DISAGG_ROUTE)
        t0 = time.perf_counter()
        with count_into(totals):
            rep = sched.run(trace)
        wall = time.perf_counter() - t0
        require_all_finished(what, trace, rep)
        lens = {r.rid: r.prompt_len for r in trace}
        want = {r for r, n in lens.items() if n >= DISAGG_ROUTE}
        bad = [h.rid for h in rep.handoffs if h.bytes != h.predicted_bytes
               or h.bytes != kv_handoff_pages(lens[h.rid], 16) * page_bytes]
        if {h.rid for h in rep.handoffs} != want or bad:
            raise AssertionError(f"{what}: handoffs {rep.handoffs}")
        agree = sum(rep.tokens_by_rid()[r][0] == tok
                    for r, tok in sched.first.items())
        log(f"[{what}] {len(trace)} requests, {rep.total_tokens} tokens, "
            f"{len(rep.handoffs)} handoffs of {rep.handoff_pages} pages, "
            f"{rep.handoff_bytes} B == kv_handoff_ops, in {wall:.2f} s; "
            f"cross-pool first token equal on {agree}/{len(sched.first)} "
            f"(measured, not held) ({smi})")
        if kind == "gspmd":
            handoff_timing(dev, smi, cfg, pre, dec,
                           list(range(1, 1 + HANDOFF_PAGES)))
        require_drained(what, dec)
        del pre, dec
    p32 = get_model(cfg32).init(seed=5, device=dev)
    with count_into(totals):
        colo = make_backend("gspmd", cfg32, p32, num_slots=4, max_len=2048,
                            paged=True, page_size=16, device=dev)
        ref = Scheduler(colo).run(disagg_trace(cfg32)).tokens_by_rid()
        del colo
        pre, dec = disagg_pools(cfg32, p32, dev, "gspmd", 1)
        rep = DisaggScheduler(pre, dec, route_prompt_len=DISAGG_ROUTE).run(
            disagg_trace(cfg32))
    if rep.tokens_by_rid() != ref:
        raise AssertionError("f32 disagg streams differ from colocated")
    require_drained("f32 disagg", dec)
    log(f"[disagg f32] L=4 full width: {len(rep.handoffs)} handoffs, "
        f"cross-pool identity held, streams == colocated run")


def failure_phase(dev, smi, params):
    """Phase 9 (A8, A9) at the full width of llama32-3b: (a) the prefix
    cache, (b) failure semantics in f32 at L = 4, (c) bf16 recompute
    agreement, (d) disaggregated pools."""
    from repro_torch.kernels import _build

    cfg = llama_config()
    totals = {name: 0 for name in _build.LAUNCHES}
    t_phase = time.perf_counter()
    prefix_cache_run(dev, smi, cfg, params, totals)
    t_a = time.perf_counter()
    cfg32 = failure_f32_run(dev, smi, cfg, totals)
    t_b = time.perf_counter()
    recompute_agreement_bf16(dev, smi, cfg, params, totals)
    t_c = time.perf_counter()
    disagg_run(dev, smi, cfg, params, cfg32, totals)
    t_d = time.perf_counter()
    log(f"[failure phase] (a) {t_a - t_phase:.1f} s, (b) {t_b - t_a:.1f} s, "
        f"(c) {t_c - t_b:.1f} s, (d) {t_d - t_c:.1f} s, "
        f"{t_d - t_phase:.1f} s; launches {totals}")
    return totals


# ---------------------------------------------------------------------------
# phase 10: the moe and hybrid families at full width
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("deepseek-moe-16b", "hymba-1.5b")
# of the smoke trace's 8: at 4 slots the fifth waits for a slot to free,
# so a slot is refilled while the others decode (b)
FAMILY_REQUESTS = 5
FAMILY_NEW = 16              # engine tokens a prompt (a)
FAMILY_LONG = (1100, 1500)   # hymba prompts past its window of 1024 (b)
FAMILY_LONG_NEW = 8
FAMILY_STEPS = 2             # decode steps timed and profiled in (d)
FAMILY_SCAN_S = 256          # hymba's prefill breakdown (d)
# hymba's f32 check (e): (prompts, length, new tokens); the first crosses
# the window during decode (the ring wraps between steps), the second is
# past it at prefill (B2's window binds, decode starts on a wrapped ring)
FAMILY_F32_WINDOWED = ((2, 1000, 40), (1, 1500, 8))


def family_kernel_rows(dev, rows):
    """Phase 10(f): B2 and B3 at the shapes phase 10's models give them,
    against their plain versions, bf16 and f32 — deepseek-moe-16b's
    16/16 heads at D 128 (groups of 1) and hymba-1.5b's attention heads
    at D 64 over its 5 KV heads: B2 on its 1100- and 1500-token prompts
    with the window of 1024, B3 on the 1024-row ring at ragged lengths,
    and B3 on rings built as the model builds them (``build_ring_cache``)
    from 700 to 1500 positions, wrapped past 1024, against the plain
    windowed prefill attention of the last query over the whole sequence.
    Folds the errors into B2's and B3's rows."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.decode_attention.ops import decode_attention_cuda
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models.blocks import build_ring_cache
    from repro_torch.models.hybrid import head_split

    g = torch.Generator(device=dev).manual_seed(13)
    i32 = dict(device=dev, dtype=torch.int32)
    log("[families kernels] B2 and B3 at phase 10's shapes")
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).replace("torch.", "")

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dt)
        err = {"flash_attention": 0.0, "decode_attention": 0.0}
        for arch in FAMILY_ARCHS:
            cfg = get_config(arch)
            Hq = head_split(cfg)[0] if cfg.family == "hybrid" \
                else cfg.num_heads
            Hkv, D, win = cfg.num_kv_heads, cfg.head_dim, cfg.sliding_window
            W = min(win or 1024, 1024)
            for S in (FAMILY_LONG if win else (333,)):
                q, k, v = randn(1, S, Hq, D), randn(1, S, Hkv, D), \
                    randn(1, S, Hkv, D)
                args = (q, k, v, torch.zeros(1, **i32),
                        torch.full((1,), S, **i32), win)
                err["flash_attention"] = max(err["flash_attention"], compare(
                    f"B2 {arch} q[1,{S},{Hq},{D}] kv {Hkv} win={win}",
                    flash_attention_cuda(*args), flash_attention_ref(*args),
                    dname))
            q = randn(4, Hq, D)
            k, v = randn(4, W, Hkv, D), randn(4, W, Hkv, D)
            lens = torch.tensor(DECODE_LENGTHS, **i32)
            err["decode_attention"] = max(err["decode_attention"], compare(
                f"B3 {arch} q[4,{Hq},{D}] kv[4,{W},{Hkv},{D}]",
                decode_attention_cuda(q, k, v, lens),
                dref.decode_attention_ref(q, k, v, lens), dname))
            if win:
                P = (700, 1024, 1025, 1500)
                kf, vf = randn(4, P[-1], Hkv, D), randn(4, P[-1], Hkv, D)
                rings = [build_ring_cache(kf[b:b + 1, :n], vf[b:b + 1, :n],
                                          W) for b, n in enumerate(P)]
                ck = torch.cat([r["k"] for r in rings])
                cv = torch.cat([r["v"] for r in rings])
                pos = torch.tensor(P, **i32)
                err["decode_attention"] = max(err["decode_attention"], compare(
                    f"B3 {arch} rings of {P} positions in {W} rows",
                    decode_attention_cuda(q, ck, cv, pos.clamp(max=W)),
                    flash_attention_ref(q[:, None], kf, vf, pos - 1, pos,
                                        win)[:, 0], dname))
        for name, e in err.items():
            rows[name][dname]["err"] = max(rows[name][dname]["err"], e)
    torch.cuda.synchronize()


class RouteLog:
    """Records the top-k expert ids of every ``moe.route`` call (sorted
    per token, kept on the card) while active."""

    def __init__(self):
        from repro_torch.models import moe as moe_lib
        self.lib, self.calls = moe_lib, []

    def __enter__(self):
        route = self.orig = self.lib.route

        def logged(cfg, router, xf):
            out = route(cfg, router, xf)
            self.calls.append(torch.sort(out[1], dim=-1).values)
            return out
        self.lib.route = logged
        return self

    def __exit__(self, *exc):
        self.lib.route = self.orig

    def flips(self, other) -> tuple:
        """(decisions whose expert set differs from ``other``'s, all
        decisions): one decision per (position, layer)."""
        if len(self.calls) != len(other.calls):
            raise AssertionError(f"{len(self.calls)} routing calls against "
                                 f"{len(other.calls)}")
        a, b = torch.cat(self.calls), torch.cat(other.calls)
        return int((a != b).any(-1).sum()), a.shape[0]


class DropLog:
    """Records (tokens of the call, dropped (token, expert) pairs) of every
    ``moe.dispatch_plan`` call while active; the counts stay on the card
    until read."""

    def __init__(self):
        from repro_torch.models import moe as moe_lib
        self.lib, self.calls = moe_lib, []

    def __enter__(self):
        plan = self.orig = self.lib.dispatch_plan

        def logged(top_i, num_experts, cap, *rest):
            out = plan(top_i, num_experts, cap, *rest)
            self.calls.append((top_i.shape[0], (~out[3]).sum()))
            return out
        self.lib.dispatch_plan = logged
        return self

    def __exit__(self, *exc):
        self.lib.dispatch_plan = self.orig

    def per_pass(self, L: int):
        """[(tokens, dropped pairs)] of each pass of L layers, in order."""
        counts = torch.stack([n for _, n in self.calls]).cpu().tolist()
        return [(self.calls[i][0], sum(counts[i:i + L]))
                for i in range(0, len(counts), L)]


def family_trace(cfg):
    """The smoke trace's first FAMILY_REQUESTS requests, and on a windowed
    family two prompts past the window (B2's window binds at their
    prefill, B3's ring wraps)."""
    import numpy as np
    from repro_torch.runtime.request import Request

    trace = smoke_trace(cfg)[:FAMILY_REQUESTS]
    if cfg.sliding_window:
        rng = np.random.default_rng(11)
        trace += [Request(rid=len(trace) + i, prompt=rng.integers(
            2, cfg.vocab_size, s).astype(np.int32),
            max_new_tokens=FAMILY_LONG_NEW) for i, s in enumerate(FAMILY_LONG)]
    return trace


def step_bytes(cfg, params, slots: int = 4, depth: int = 130) -> dict:
    """Bytes one decode step of ``slots`` sequences at position ~``depth``
    must move: every block weight (the dense capacity buffer runs every
    expert every step), the head, the slots' embedding rows and the KV
    rows read; ``experts`` the routed experts' share."""
    blocks = params["blocks"]
    size = {k: t.numel() * t.element_size() for k, t in blocks.items()}
    head = params.get("lm_head", params["embed"])
    kv = (2 * cfg.num_layers * slots * min(depth, cfg.sliding_window or depth)
          * cfg.num_kv_heads * cfg.head_dim * head.element_size())
    emb = slots * cfg.d_model * params["embed"].element_size()
    return {"step": sum(size.values()) + head.numel() * head.element_size()
            + kv + emb,
            "experts": sum(size.get(k, 0) for k in ("we1", "we2", "we3"))}


def labelled(lib, name: str, label: str):
    """Wrap ``lib.name`` in a ``record_function(label)`` range; returns a
    callable that restores it."""
    from torch.profiler import record_function
    orig = getattr(lib, name)

    def ranged(*a, **k):
        with record_function(label):
            return orig(*a, **k)
    setattr(lib, name, ranged)
    return lambda: setattr(lib, name, orig)


def range_times(prof, label: str):
    """(host ms, device ms) of the ``label`` ranges in a profiled window:
    the host-side ranges' spans and the device time of the records
    launched inside them (0 device ms: not measured)."""
    host = [e for e in prof.events() if e.name == label and not _on_card(e)]
    return (sum(e.time_range.elapsed_us() for e in host) / 1e3,
            sum(e.device_time_total for e in host) / 1e3)


def _full_width(dev, cfg, tag):
    """Seeded bf16 weights of ``cfg`` on the card, after freeing the
    allocator's cache and resetting the peak."""
    from repro_torch.models.transformer import get_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = get_model(cfg).init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["blocks"].values()) + sum(
        t.numel() for k, t in params.items() if k != "blocks")
    log(f"{tag} full width: L={cfg.num_layers} d={cfg.d_model} heads="
        f"{cfg.num_heads}/{cfg.num_kv_heads} D={cfg.head_dim} window="
        f"{cfg.sliding_window} vocab={cfg.vocab_size} {cfg.dtype}, {n_params / 1e9:.3f} B parameters, "
        f"init {time.perf_counter() - t0:.1f} s")
    return params


def serve_against_solo(dev, smi, cfg, params, trace, totals, max_len: int,
                       branch: int = 0, ctx=contextlib.nullcontext()):
    """The contiguous Scheduler at 4 slots over ``trace`` (run inside
    ``ctx``), every request finished, a slot refilled while the others
    decode and the launches of the formula; then each request alone
    through the engine at batch 1, its stream equal to the scheduler's."""
    from repro_torch.kernels import _build
    from repro_torch.runtime.backends import make_backend
    from repro_torch.runtime.engine import InferenceEngine
    from repro_torch.runtime.scheduler import Scheduler

    arch, L, tag = cfg.name, cfg.num_layers, f"[{cfg.name}]"
    backend = make_backend("gspmd", cfg, params, num_slots=4,
                           max_len=max_len, device=dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    with ctx:
        report = Scheduler(backend).run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    require_all_finished(f"{arch} contiguous", trace, report)
    n_dec = sum(1 for r in report.steps if r.phase == "decode")
    expect_launches(f"{arch} contiguous", counts, L,
                    passes=len(trace) + n_dec, flash=len(trace),
                    decode=n_dec, paged=0, branch=branch)
    for k in totals:
        totals[k] += counts[k]
    first_done = min(m.finished for m in report.metrics)
    refills = sum(m.admitted >= first_done for m in report.metrics)
    log(f"{tag} serve contiguous: {len(report.metrics)} requests (prompts "
        f"{sorted(len(r.prompt) for r in trace)}), {report.total_tokens} "
        f"tokens, {n_dec} decode steps, {refills} admitted into a freed "
        f"slot, in {wall:.2f} s ({smi})")
    if not refills:
        raise AssertionError(f"{arch}: no slot was refilled while others "
                             "decoded")
    log(f"{tag} serve contiguous summary {json.dumps(report.summary())}")
    del backend
    solo = {}

    def solo_runs():
        for req in trace:
            solo[req.rid] = InferenceEngine(
                cfg, params, max_len=max_len, device=dev).generate(
                req.prompt[None], max_new_tokens=req.max_new_tokens)[0]
    n_new = sum(r.max_new_tokens for r in trace)
    t0 = time.perf_counter()
    drive_counted(f"{arch} solo engine runs", solo_runs, totals, L,
                  branch=branch, passes=n_new, flash=len(trace),
                  decode=n_new - len(trace), paged=0)
    log(f"{tag} solo engine runs: {len(trace)} requests in "
        f"{time.perf_counter() - t0:.2f} s")
    streams = report.tokens_by_rid()
    same = [r for r in streams if streams[r] == solo[r].tolist()]
    for r in streams:
        if r not in same:
            a, b = streams[r], solo[r].tolist()
            at = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            log(f"{tag} request {r}: stream differs from solo at token {at}")
    log(f"{tag} contiguous streams equal to solo batch-1 engine runs: "
        f"{len(same)}/{len(streams)} (bf16)")
    if len(same) != len(streams):
        raise AssertionError(f"{arch}: scheduler streams differ from solo")


def family_run(dev, smi, arch: str, totals):
    """Phase 10 for one model: (a) the engine, (b) the contiguous
    Scheduler against solo runs, (c) the kernel path against the plain
    path, (d) the time breakdowns, (e) f32 kernel path == plain path."""
    from repro_torch.configs import get_config
    from repro_torch.models import hybrid as hybrid_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime.engine import InferenceEngine

    cfg = get_config(arch)
    L, moe = cfg.num_layers, cfg.family == "moe"
    branch = 2 if cfg.family == "hybrid" else 0
    max_len = 2048 if cfg.sliding_window else 1024
    tag = f"[{arch}]"

    def drive(what, fn, **expect):
        return drive_counted(f"{arch} {what}", fn, totals, L, branch=branch,
                             **expect)

    params = _full_width(dev, cfg, tag)
    finite = FiniteLogits(get_model(cfg))
    marks = [time.perf_counter()]

    # (a) the engine: 2 prompts x 128 tokens, FAMILY_NEW new (two decode
    # chunks at 8), decode_chunk 1 and 8
    n = FAMILY_NEW
    prompts = torch.randint(2, cfg.vocab_size, (2, 128),
                            generator=torch.Generator().manual_seed(1))
    outs = []
    for chunk in (1, 8):
        t0 = time.perf_counter()
        outs.append(drive(f"engine chunk {chunk}", lambda: InferenceEngine(
            cfg, params, max_len=1024, decode_chunk=chunk, device=dev)
            .generate(prompts, max_new_tokens=n), passes=n, flash=1,
            decode=n - 1, paged=0))
        log(f"{tag} engine decode_chunk {chunk}: 2x128 -> 2x{n} tokens in "
            f"{time.perf_counter() - t0:.3f} s ({smi})")
    out = outs[0]
    if tuple(out.shape) != (2, n) or int(out.min()) < 0 or \
            int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"{arch}: engine output {tuple(out.shape)} out "
                             "of range")
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError(f"{arch}: decode_chunk 1 and 8 give other "
                             "tokens")
    marks.append(time.perf_counter())

    # (b) the contiguous Scheduler at 4 slots against solo batch-1 runs
    drops = DropLog() if moe else contextlib.nullcontext()
    serve_against_solo(dev, smi, cfg, params, family_trace(cfg), totals,
                       max_len, branch, drops)
    if moe:
        passes = drops.per_pass(L)
        dec = [n for t, n in passes if t == 4]
        pre = [(t, n) for t, n in passes if t != 4]
        log(f"{tag} MoE drops: prefill (prompt tokens, dropped (token, "
            f"expert) pairs over {L} layers) {pre}; decode steps {len(dec)}, "
            f"dropped {sum(dec)}")
        if sum(dec):
            raise AssertionError(f"{arch}: a 4-slot decode step dropped "
                                 f"{sum(dec)} pairs (capacity 6 a expert)")
    n = finite.assert_all(f"{arch} serving")
    log(f"{tag} {n} logit batches, all finite")
    marks.append(time.perf_counter())

    # (c) the kernel path against the plain path, teacher-forced, held to
    # LOGIT_MATCH_FLOOR / LOGIT_DRIFT_CEILING.  A top-k choice is
    # discontinuous in x, so a last-bit difference can send a token to
    # another expert; where a family misses the floor it is held instead to
    # land no further from the plain path than the yardstick (the plain
    # path with f64 attention) does, within YARDSTICK_MARGIN, as rwkv6-7b is
    # held.
    prompt = torch.randint(2, cfg.vocab_size, (1, FORCED),
                           generator=torch.Generator().manual_seed(2)).to(dev)
    logs = [RouteLog() for _ in range(3)] if moe else None

    def traced(i, fn):
        if not moe:
            return fn()
        with logs[i]:
            return fn()
    ref = traced(0, lambda: teacher_forced(get_model(cfg, plain=True),
                                           params, prompt, False))
    got = traced(1, lambda: drive(
        "teacher-forced", lambda: teacher_forced(get_model(cfg), params,
                                                 prompt, False),
        passes=1 + FORCED - SPLIT, flash=1, decode=FORCED - SPLIT, paged=0))
    if moe:
        flips, decisions = logs[1].flips(logs[0])
        log(f"{tag} routing decisions (position, layer) whose top-"
            f"{cfg.moe.top_k} expert set differs from the plain path's: "
            f"kernel path {flips}/{decisions}")
    yard = []

    def yardstick():
        """(top-1 match, max drift) of the plain path with f64 attention
        against the plain path, run once, where a floor is first missed."""
        if not yard:
            exact = exact_attention(lambda: traced(2, lambda: teacher_forced(
                get_model(cfg, plain=True), params, prompt, False)))
            yard.extend(agreement(exact, ref))
            log(f"[compare] bf16 {arch} plain path with f64 attention vs "
                f"plain (the yardstick): top-1 match {yard[0]:.4f}, max "
                f"logit drift {yard[1]:.4f}")
            if moe:
                y_flips, _ = logs[2].flips(logs[0])
                log(f"{tag} routing decisions whose expert set differs from "
                    f"the plain path's: yardstick {y_flips}/{decisions}")
        return yard

    what = f"bf16 {arch} kernel path (B1, add_rms_norm, B2 + B3) vs plain"
    if not within(what, got, ref, LOGIT_MATCH_FLOOR, LOGIT_DRIFT_CEILING):
        y_match, y_drift = yardstick()
        hold(f"{what}, held to the yardstick's {y_match:.4f} / "
             f"{y_drift:.4f} within {YARDSTICK_MARGIN}", got, ref,
             y_match - YARDSTICK_MARGIN, y_drift + YARDSTICK_MARGIN)
    marks.append(time.perf_counter())

    # (d) time breakdowns
    model = get_model(cfg)
    size = step_bytes(cfg, params)
    if moe:
        restore = labelled(moe_lib, "moe_ffn", RANGES[2])
        try:
            MEASURED[ROOFLINE_STEPS[2]] = decode_breakdown(
                dev, model, params, smi, arch, FAMILY_STEPS,
                ranged=RANGES[2])
        finally:
            restore()
        log(f"{tag} decode step bytes bound: {size['step'] / 1e9:.2f} GB "
            f"({size['experts'] / 1e9:.2f} GB of routed experts) at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
            f"{1e3 * size['step'] / HBM_BYTES_PER_S:.3f} ms "
            f"(experts {1e3 * size['experts'] / HBM_BYTES_PER_S:.3f} ms)")
    else:
        decode_breakdown(dev, model, params, smi, arch, FAMILY_STEPS)
        restore = labelled(hybrid_lib, "selective_scan", RANGES[3])
        try:
            prefill_breakdown(dev, model, params, smi, FAMILY_SCAN_S,
                              ranged=RANGES[3])
        finally:
            restore()
    log(f"{tag} bf16 peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    marks.append(time.perf_counter())
    if moe:
        expert_tp_run(dev, smi, cfg, params, prompt, got, logs[1], yardstick,
                      totals)
    marks.append(time.perf_counter())
    del params, model, ref, got, logs
    torch.cuda.empty_cache()

    # (e) f32: greedy tokens of the kernel path == the plain path's, moe
    # at 4 layers (~11 GB; all 28 would not fit), hybrid at full depth on
    # prompts across and past its window
    torch.cuda.reset_peak_memory_stats(dev)
    layers = 4 if moe else L
    cfg32 = dataclasses.replace(cfg, num_layers=layers, dtype="float32")
    p32 = get_model(cfg32).init(seed=3, device=dev)
    gen = torch.Generator().manual_seed(4)
    for n, S, new in (FAMILY_F32_WINDOWED if cfg.sliding_window
                      else ((2, 128, 32),)):
        prompts = torch.randint(2, cfg.vocab_size, (n, S), generator=gen)
        a, b = (InferenceEngine(cfg32, p32, max_len=max_len, device=dev,
                                plain=plain).generate(prompts,
                                                      max_new_tokens=new)
                for plain in (False, True))
        same = bool(torch.equal(a, b))
        log(f"[compare f32] {arch} L={layers} full width, greedy {n}x{S} -> "
            f"{n}x{new} tokens kernel path == plain path: {same}; peak "
            f"device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        if not same:
            raise AssertionError(f"{arch} f32 greedy tokens differ between "
                                 "the kernel and the plain path")
        if moe:
            expert_tp_f32(dev, cfg32, p32, prompts, new, a, max_len, totals)
    del p32
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    log(f"{tag} " + ", ".join(f"({k}) {b - a:.1f} s" for k, a, b in zip(
        "abcdge", marks, marks[1:])))


FAMILY_TP_MESHES = ((1, 2), (1, 4), (2, 2))   # (data, model) of (g)
FAMILY_TP_FORCED = (1, 4)                     # (g)(iv) and (v)
FAMILY_TP_NEW = 8                             # engine tokens a prompt (g)(i)


def expert_tp_run(dev, smi, cfg, params, prompt, got, routes, yardstick,
                  totals):
    """Phase 10(g): deepseek-moe-16b on the expert-TP path
    (``moe_dispatch`` "local", ``moe_ffn_local`` on a virtual (data,
    model) mesh set in ``meshctx``), on (f)'s bf16 weights.  On each mesh
    of FAMILY_TP_MESHES: (i) the comm log of a forward pass over 4 x 64
    tokens (one model all-reduce of a data shard's [tokens, h] a layer,
    and at dp = 2 the aux loss's all-reduce over ``data``) and of the
    engine's prefill + decode steps (the model all-reduce alone: those
    passes drop the aux loss), nothing else; (ii) every run's launches
    equal the dense formula (the FFN runs no kernel).  At
    FAMILY_TP_FORCED: (iv) teacher-forced against (c)'s GSPMD kernel path
    ``got``, routing flips against its ``routes``, held to the floor and
    ceiling or to the yardstick within the margin as (c) is; (v) a decode
    step's breakdown with the ``moe.ffn`` range on ``moe_ffn_local``."""
    from repro_torch.core.comm import VirtualMesh
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime import meshctx
    from repro_torch.runtime.engine import InferenceEngine

    arch, L, h = cfg.name, cfg.num_layers, cfg.d_model
    tag = f"[{arch} expert-TP]"
    model = get_model(dataclasses.replace(cfg, moe_dispatch="local"))
    toks = torch.randint(2, cfg.vocab_size, (4, 64),
                         generator=torch.Generator().manual_seed(12)).to(dev)
    n = FAMILY_TP_NEW

    def drive(what, fn, **expect):
        return drive_counted(f"{arch} expert-TP {what}", fn, totals, L,
                             **expect)
    try:
        for dp, t in FAMILY_TP_MESHES:
            mesh = VirtualMesh((dp, t), ("data", "model"))
            meshctx.set_mesh(mesh)
            t0 = time.perf_counter()
            drive(f"({dp}, {t}) forward", lambda: model.forward(params, toks),
                  passes=1, flash=1, decode=0, paged=0)
            got_fwd = [(o.collective, o.count, o.shape, o.workers,
                        o.dtype_bytes) for o in mesh.summary()]
            mesh.log.clear()
            drive(f"({dp}, {t}) engine", lambda: InferenceEngine(
                model.cfg, params, max_len=128, device=dev).generate(
                toks, max_new_tokens=n), passes=n, flash=1, decode=n - 1,
                paged=0)
            got_eng = [(o.collective, o.count, o.shape, o.workers,
                        o.dtype_bytes) for o in mesh.summary()]
            want_fwd = [("allreduce", L, (4 * 64 // dp, h), t, 2)] + (
                [("allreduce", L, (1, 1), dp, 4)] if dp > 1 else [])
            want_eng = [("allreduce", L, (4 * 64 // dp, h), t, 2),
                        ("allreduce", (n - 1) * L, (4 // dp, h), t, 2)]
            log(f"{tag} ({dp}, {t}): comm log of a 4x64 forward {got_fwd}; "
                f"of the engine's prefill + {n - 1} decode steps {got_eng}; "
                f"{time.perf_counter() - t0:.2f} s")
            if got_fwd != want_fwd or got_eng != want_eng:
                raise AssertionError(f"{tag} ({dp}, {t}): comm log "
                                     f"{got_fwd} / {got_eng}, expected "
                                     f"{want_fwd} / {want_eng}")
        meshctx.set_mesh(VirtualMesh(FAMILY_TP_FORCED, ("data", "model")))
        t0 = time.perf_counter()
        with RouteLog() as rl:
            tp_got = drive(f"{FAMILY_TP_FORCED} teacher-forced",
                           lambda: teacher_forced(model, params, prompt,
                                                  False),
                           passes=1 + FORCED - SPLIT, flash=1,
                           decode=FORCED - SPLIT, paged=0)
        flips, decisions = rl.flips(routes)
        log(f"{tag} {FAMILY_TP_FORCED} teacher-forced in "
            f"{time.perf_counter() - t0:.2f} s; routing decisions whose "
            f"top-{cfg.moe.top_k} expert set differs from the GSPMD "
            f"path's: {flips}/{decisions}")
        what = (f"bf16 {arch} expert-TP {FAMILY_TP_FORCED} vs the GSPMD "
                "kernel path")
        if not within(what, tp_got, got, LOGIT_MATCH_FLOOR,
                      LOGIT_DRIFT_CEILING):
            y_match, y_drift = yardstick()
            hold(f"{what}, held to the yardstick's {y_match:.4f} / "
                 f"{y_drift:.4f} within {YARDSTICK_MARGIN}", tp_got, got,
                 y_match - YARDSTICK_MARGIN, y_drift + YARDSTICK_MARGIN)
        restore = labelled(moe_lib, "moe_ffn_local", RANGES[2])
        try:
            decode_breakdown(dev, model, params, smi,
                             f"{arch} expert-TP {FAMILY_TP_FORCED}",
                             FAMILY_STEPS, ranged=RANGES[2])
        finally:
            restore()
    finally:
        meshctx.set_mesh(None)


def expert_tp_f32(dev, cfg32, p32, prompts, new, want, max_len, totals):
    """Phase 10(g)(iii): f32 at L = 4, on meshes (1, t): greedy tokens of
    the expert-TP path equal the GSPMD path's ``want`` (dp = 1 routes and
    caps the same tokens), with the dense launch formula."""
    from repro_torch.core.comm import VirtualMesh
    from repro_torch.runtime import meshctx
    from repro_torch.runtime.engine import InferenceEngine

    local = dataclasses.replace(cfg32, moe_dispatch="local")
    try:
        for t in (2, 4):
            meshctx.set_mesh(VirtualMesh((1, t), ("data", "model")))
            out = drive_counted(
                f"{cfg32.name} f32 expert-TP (1, {t})",
                lambda: InferenceEngine(local, p32, max_len=max_len,
                                        device=dev).generate(
                    prompts, max_new_tokens=new),
                totals, cfg32.num_layers, passes=new, flash=1,
                decode=new - 1, paged=0)
            same = bool(torch.equal(out, want))
            log(f"[compare f32] {cfg32.name} L={cfg32.num_layers} expert-TP "
                f"(1, {t}) greedy tokens == GSPMD path: {same}")
            if not same:
                raise AssertionError(f"{cfg32.name} f32 expert-TP (1, {t}) "
                                     "tokens differ from the GSPMD path")
    finally:
        meshctx.set_mesh(None)


def families_phase(dev, smi, rows):
    """Phase 10 (A11, part 1): B2 and B3 at the two models' shapes (f),
    then deepseek-moe-16b and hymba-1.5b at full width, one after the
    other, each freed before the next."""
    from repro_torch.kernels import _build

    torch.cuda.init()           # the allocator, for the peak memory stats
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    totals = {name: 0 for name in _build.LAUNCHES}
    t_phase = time.perf_counter()
    family_kernel_rows(dev, rows)
    times = [f"(f) {time.perf_counter() - t_phase:.1f} s"]
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        family_run(dev, smi, arch, totals)
        times.append(f"{arch} {time.perf_counter() - t0:.1f} s")
    log(f"[families phase] {', '.join(times)}, "
        f"{time.perf_counter() - t_phase:.1f} s; launches {totals}")
    return totals


# ---------------------------------------------------------------------------
# phase 11: the encoder and vlm families at full width
# ---------------------------------------------------------------------------

ENC_CLIPS = ((2, 1000), (1, 1500))  # (clips, frames): 20 s and 30 s at 50 Hz
VLM_ARCH, ENC_ARCH = "paligemma-3b", "hubert-xlarge"
VLM_TEXT = (16, 64)         # text tokens after the 256 image-prefix positions
VLM_NEW = 16                # greedy tokens a prompt (two decode chunks at 8)
VLM_F32 = (2, 48, 16)       # f32 at L = 4: (prompts, text tokens, new tokens)


def _held_to_plain(what, got, ref, exact):
    """The kernel path's logits against the plain path's, beside the
    yardstick (``exact``: the plain path with f64 attention): held to
    LOGIT_MATCH_FLOOR / LOGIT_DRIFT_CEILING, or, where it misses them, to
    land no further from the plain path than the yardstick within
    YARDSTICK_MARGIN."""
    y_match, y_drift = agreement(exact, ref)
    log(f"[compare] {what}: yardstick (the plain path with f64 attention) "
        f"vs plain: top-1 match {y_match:.4f}, max logit drift "
        f"{y_drift:.4f}; the plain path's largest |logit| "
        f"{float(ref.abs().max()):.1f}")
    if not within(what, got, ref, LOGIT_MATCH_FLOOR, LOGIT_DRIFT_CEILING):
        hold(f"{what}, held to the yardstick's {y_match:.4f} / "
             f"{y_drift:.4f} within {YARDSTICK_MARGIN}", got, ref,
             y_match - YARDSTICK_MARGIN, y_drift + YARDSTICK_MARGIN)


def encoder_run(dev, smi, totals):
    """Phase 11(b): hubert-xlarge at full width, bf16 from seed 0: encode
    two 1000-frame clips and one of 1500 frames (1 B1, 2L add_rms_norm and
    L B2 bidirectional a pass; no B3, no B4), the logits' argmax over
    frames and max drift against the plain path's beside the yardstick;
    one pass's breakdown; f32 at L = 4, logits within 1e-4 of the plain
    path's."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime.engine import InferenceEngine

    cfg = get_config(ENC_ARCH)
    L, tag = cfg.num_layers, f"[{ENC_ARCH}]"
    params = _full_width(dev, cfg, tag)
    gen = torch.Generator(device=dev).manual_seed(21)
    clips = [torch.randn((n, S, cfg.d_model), generator=gen, device=dev
                         ).to(torch.bfloat16) for n, S in ENC_CLIPS]
    eng = InferenceEngine(cfg, params, device=dev)
    t0 = time.perf_counter()
    got = drive_counted(f"{ENC_ARCH} encode", lambda: [
        eng.encode(c) for c in clips], totals, L, passes=len(clips),
        flash=len(clips), decode=0, paged=0)
    log(f"{tag} encode {' + '.join(f'{n}x{S}' for n, S in ENC_CLIPS)} "
        f"frames in {time.perf_counter() - t0:.3f} s ({smi})")
    for out, (n, S) in zip(got, ENC_CLIPS):
        if tuple(out.shape) != (n, S, cfg.padded_vocab) or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{ENC_ARCH}: encode gave "
                                 f"{tuple(out.shape)} or non-finite logits")
    plain = InferenceEngine(cfg, params, device=dev, plain=True)

    def frames(outs):
        return torch.cat([o[..., :cfg.vocab_size].reshape(-1, cfg.vocab_size)
                          for o in outs]).float()
    ref = frames([plain.encode(c) for c in clips])
    exact = frames(exact_attention(lambda: [plain.encode(c)
                                            for c in clips]))
    _held_to_plain(f"bf16 {ENC_ARCH} encode (B1, add_rms_norm, B2 "
                   f"bidirectional at D 80) vs plain, per frame",
                   frames(got), ref, exact)
    del got, ref, exact
    prefill_breakdown(dev, get_model(cfg), params, smi, ENC_CLIPS[0][1],
                      run=lambda: eng.encode(clips[0][:1]))
    log(f"{tag} bf16 peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    del params, eng, plain, clips
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    p32 = get_model(cfg32).init(seed=3, device=dev)
    f = torch.randn((2, 1000, cfg.d_model), generator=gen, device=dev)
    a, b = (InferenceEngine(cfg32, p32, device=dev, plain=plain).encode(f)
            for plain in (False, True))
    compare(f"{ENC_ARCH} f32 L=4 encode logits, kernel vs plain", a, b,
            "float32")
    del p32, a, b
    torch.cuda.empty_cache()


def vlm_run(dev, smi, totals):
    """Phase 11(c): paligemma-3b at full width, bf16 from seed 0, with 256
    image-prefix embeddings (randn · 0.02): generate on two prompts of 16
    and 64 text tokens, greedy tokens equal at decode_chunk 1 and 8 (L B2
    prefix mode a prefill, L B3 at D 256 a decode step); the kernel path
    teacher-forced against the plain path beside the yardstick, with and
    without each position's input-token column (at random init the model
    echoes its input, so tokens and top-1 alone would pass a wrong
    kernel); text requests through the contiguous Scheduler against solo
    runs; one prefill pass's breakdown; f32 at L = 4, logits within 1e-4
    of the plain path's at the prefill's last position and every decode
    step, and greedy tokens kernel == plain."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime.engine import InferenceEngine

    cfg = get_config(VLM_ARCH)
    L, P, tag = cfg.num_layers, cfg.num_prefix_tokens, f"[{VLM_ARCH}]"
    params = _full_width(dev, cfg, tag)
    gen = torch.Generator(device=dev).manual_seed(22)

    def prefix(n, h=cfg.d_model):
        return 0.02 * torch.randn((n, P, h), generator=gen, device=dev)

    def prompts(n, S):
        return torch.randint(2, cfg.vocab_size, (n, S), generator=gen,
                             device=dev, dtype=torch.int32)
    marks = [time.perf_counter()]

    # (c1) the engine with the image prefix, decode_chunk 1 and 8
    n = VLM_NEW
    for S in VLM_TEXT:
        toks, pe = prompts(1, S), prefix(1)
        outs = [drive_counted(
            f"{VLM_ARCH} engine {P}+{S} chunk {chunk}", lambda: InferenceEngine(
                cfg, params, max_len=P + S + n, decode_chunk=chunk,
                device=dev).generate(toks, max_new_tokens=n, prefix_emb=pe),
            totals, L, passes=n, flash=1, decode=n - 1, paged=0)
            for chunk in (1, 8)]
        if tuple(outs[0].shape) != (1, n) or int(outs[0].min()) < 0 or \
                int(outs[0].max()) >= cfg.vocab_size:
            raise AssertionError(f"{VLM_ARCH}: engine output out of range")
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"{VLM_ARCH}: decode_chunk 1 and 8 give "
                                 "other tokens")
        log(f"{tag} engine {P} prefix + {S} text -> {n} tokens, "
            f"decode_chunk 1 == 8")
    marks.append(time.perf_counter())

    # (c2) teacher-forced after the prefix: kernel path vs plain path
    prompt, pe = prompts(1, FORCED), prefix(1)
    ref = teacher_forced(get_model(cfg, plain=True), params, prompt, False,
                         pe)
    got = drive_counted(f"{VLM_ARCH} teacher-forced", lambda: teacher_forced(
        get_model(cfg), params, prompt, False, pe), totals, L,
        passes=1 + FORCED - SPLIT, flash=1, decode=FORCED - SPLIT, paged=0)
    exact = exact_attention(lambda: teacher_forced(
        get_model(cfg, plain=True), params, prompt, False, pe))
    V = cfg.vocab_size          # the pad columns hold finfo.min on both
    _held_to_plain(f"bf16 {VLM_ARCH} kernel path (B1, add_rms_norm, B2 "
                   "prefix + B3 at D 256) vs plain", got[:, :V], ref[:, :V],
                   exact[:, :V])
    # at random init the tied, sqrt(h)-scaled embedding gives each
    # position's own token a logit near h, far above the rest, so the
    # top-1 above says little; the same comparison without that column
    keep = torch.ones_like(ref[:, :V], dtype=torch.bool).scatter_(
        1, prompt[0, SPLIT - 1:FORCED, None].long(), False)
    _held_to_plain(f"bf16 {VLM_ARCH} kernel path vs plain, the input "
                   "token's column removed", *(
                       x[:, :V][keep].view(-1, V - 1)
                       for x in (got, ref, exact)))
    del ref, got, exact
    marks.append(time.perf_counter())

    # (c3) text requests through the contiguous Scheduler (no prefix: the
    # backends take none, as in JAX)
    finite = FiniteLogits(get_model(cfg))
    serve_against_solo(dev, smi, cfg, params,
                       smoke_trace(cfg)[:FAMILY_REQUESTS], totals, 1024)
    log(f"{tag} {finite.assert_all(f'{VLM_ARCH} serving')} logit batches, "
        "all finite")
    marks.append(time.perf_counter())

    # (d) one prefill pass of the prefix and 64 text tokens
    model, toks, pe = get_model(cfg), prompts(1, VLM_TEXT[-1]), prefix(1)
    prefill_breakdown(dev, model, params, smi, P + VLM_TEXT[-1],
                      run=lambda: model.prefill(params, toks, 1024, pe))
    log(f"{tag} bf16 peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())

    # (c5) f32 at L = 4: the kernel path's logits within the f32 tolerance
    # of the plain path's at the prefill's last position and every decode
    # step (teacher-forced after the prefix); greedy tokens equal
    nb, S, new = VLM_F32
    cfg32 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    p32 = get_model(cfg32).init(seed=3, device=dev)
    prompt, pe = prompts(1, FORCED), prefix(1)
    a, b = (teacher_forced(get_model(cfg32, plain=plain), p32, prompt, False,
                           pe)[:, :cfg.vocab_size] for plain in (False, True))
    compare(f"{VLM_ARCH} f32 L=4 logits, prefill + {FORCED - SPLIT} decode "
            "steps, kernel vs plain", a, b, "float32")
    toks, pe = prompts(nb, S), prefix(nb)
    a, b = (InferenceEngine(cfg32, p32, max_len=P + S + new, device=dev,
                            plain=plain).generate(toks, max_new_tokens=new,
                                                  prefix_emb=pe)
            for plain in (False, True))
    same = bool(torch.equal(a, b))
    log(f"[compare f32] {VLM_ARCH} L=4 full width, greedy {nb}x({P}+{S}) -> "
        f"{nb}x{new} tokens kernel path == plain path: {same}")
    if not same:
        raise AssertionError(f"{VLM_ARCH} f32 greedy tokens differ between "
                             "the kernel and the plain path")
    del p32
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    log(f"{tag} " + ", ".join(f"({k}) {b - a:.1f} s" for k, a, b in zip(
        ("c1", "c2", "c3", "d", "c5"), marks, marks[1:])))


def encoder_vlm_phase(dev, smi):
    """Phase 11 (A11, part 2): hubert-xlarge, then paligemma-3b, at full
    width, each freed before the next (B2 and B3 at their shapes, 11(a),
    run beside phase 2)."""
    from repro_torch.kernels import _build

    torch.cuda.init()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    totals = {name: 0 for name in _build.LAUNCHES}
    times = []
    t_phase = time.perf_counter()
    for arch, run in ((ENC_ARCH, encoder_run), (VLM_ARCH, vlm_run)):
        t0 = time.perf_counter()
        run(dev, smi, totals)
        times.append(f"{arch} {time.perf_counter() - t0:.1f} s")
    log(f"[encoder/vlm phase] {', '.join(times)}, "
        f"{time.perf_counter() - t_phase:.1f} s; launches {totals}")
    return totals

# ---------------------------------------------------------------------------
# phase 12: training at the full width of llama32-3b
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 2, 512      # every llama32-3b batch: B sequences of S
TRAIN_F32_LAYERS = 4           # (a) and (f): f32 at full width, cut depth
TRAIN_STEPS = 8                # (c): AdamW steps on one fixed batch
TRAIN_LR = (1e-3, 2)           # (c): cosine_schedule(peak, warmup, steps)
# (a), (g): every f32 gradient leaf of the kernel path within this share of
# the leaf's largest |gradient| on the plain path (the kernels' f32 sums in
# another order move the activations by ~1e-6 of their scale, and their
# backward is the plain versions' gradient)
GRAD_BOUND = 1e-3
GRAD_COS_FLOOR = 0.99          # (b): the worst bf16 leaf's cosine
# (e): at LLAMA_DEPTH, 3.2 GB of bf16 parameters, 3.2 of gradients, 12.8
# of f32 moments and ~1.5 of activations at B = 2, S = 512
TRAIN_MEMORY_GB = 21
# (g): (arch, B, S) at L = 2 in f32; hymba's 1100 tokens pass its window
# of 1024, paligemma's S text tokens follow its 256 prefix positions
TRAIN_FAMILIES = (("rwkv6-7b", 2, 512), ("deepseek-moe-16b", 2, 512),
                  ("hymba-1.5b", 1, 1100), ("hubert-xlarge", 2, 512),
                  ("paligemma-3b", 2, 256))


def train_launches(cfg, passes: int = 1, remat: str = "none") -> dict:
    """The hand-written launches of ``passes`` training passes: each
    forward runs the serving pass's norm sites (1 B1, hymba 1 + 2L; 2L
    add_rms_norm) and L B2 (B10 for the ssm family); the backward runs the
    plain versions' gradients and launches none, but under remat its
    recompute runs each layer's kernels again (all but the final norm)."""
    from repro_torch.kernels import _build
    L, again = cfg.num_layers, remat != "none"
    branch = 2 * L if cfg.family == "hybrid" else 0
    want = dict.fromkeys(_build.LAUNCHES, 0)
    want["rmsnorm"] = passes * (1 + branch) * (1 + again)
    want["add_rms_norm"] = passes * (2 * L + again * (2 * L - 1))
    layer = "wkv6" if cfg.family == "ssm" else "flash_attention"
    want[layer] = passes * L * (1 + again)
    return want


def counted(what, want, totals, fn):
    """fn() as one counted run (``count_into``), its launches held to
    ``want``."""
    with count_into(totals) as counts:
        out = fn()
    log(f"  launches {what}: "
        f"{ {k: n for k, n in counts.items() if n} }")
    if counts != want:
        raise AssertionError(f"{what}: launches {counts} != expected {want}")
    return out


def train_batch(cfg, B: int, S: int, dev, seed: int = 0) -> dict:
    """A batch on the card as the training launcher makes it from ``seed``:
    SyntheticTokens rows [B, S] (after the vlm's image-prefix embeddings;
    the encoder's frames and targets instead)."""
    import numpy as np
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.train import make_batch
    from repro_torch.models.layers import torch_dtype
    tokens = SyntheticTokens(cfg.vocab_size, S, B, seed=seed).batch_at(0)
    batch = make_batch(cfg, tokens, np.random.default_rng(seed), B, S,
                       torch_dtype(cfg.dtype))
    return {k: v.to(dev) for k, v in batch.items()}


def loss_grads(cfg, params, batch, plain: bool = False,
               remat: str = "none", loss_impl: str = "dense"):
    """(loss, gradient tree) of make_loss_fn on the kernel or plain path."""
    from repro_torch.models.transformer import get_model
    from repro_torch.runtime import train
    model = get_model(dataclasses.replace(cfg, remat=remat), plain=plain)
    loss, _, grads = train.loss_and_grads(
        train.make_loss_fn(model, loss_impl), params, batch)
    return float(loss), grads


def grads_within(what, got, want, bound: float = GRAD_BOUND) -> float:
    """Hold every leaf of ``got`` within ``bound`` · max |leaf of want| of
    ``want``; log the worst leaf; returns its ratio."""
    import math
    from repro_torch.checkpoint.store import flatten
    ref = flatten(want)
    worst, at = 0.0, None
    for key, g in flatten(got).items():
        ratio = float((g.float() - ref[key].float()).abs().max()) / max(
            float(ref[key].float().abs().max()), 1e-30)
        if not math.isfinite(ratio) or ratio > worst:
            worst, at = ratio, key
        if not math.isfinite(ratio):
            break
    ok = worst <= bound
    log(f"[train] {what}: worst leaf {at}: max |diff| / max |grad| "
        f"{worst:.3e} (bound {bound:g}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: gradient leaf {at} off by {worst}")
    return worst


def grad_agreement(got, want):
    """(worst cosine, its leaf, worst relative norm error |got - want| /
    |want|, its leaf) over the leaves, summed in f64 a block at a time."""
    from repro_torch.checkpoint.store import flatten
    ref = flatten(want)
    cos, rel = (2.0, None), (-1.0, None)
    for key, g in flatten(got).items():
        dot = gg = ww = dd = 0.0
        for a, b in zip(g.flatten().split(1 << 25),
                        ref[key].flatten().split(1 << 25)):
            a, b = a.double(), b.double()
            dot += float(a @ b)
            gg += float(a @ a)
            ww += float(b @ b)
            dd += float((a - b) @ (a - b))
        c = dot / max((gg * ww) ** 0.5, 1e-300)
        r = (dd / max(ww, 1e-300)) ** 0.5
        cos = min(cos, (c, key))
        rel = max(rel, (r, key))
    return cos[0], cos[1], rel[0], rel[1]


def train_f32_run(dev, cfg32, params32, totals):
    """Phase 12(a): f32 at L = 4, full width: the kernel path's gradient
    against the plain path's, remat "full" and "dots" against none, the
    fused loss against the dense one, each leaf within GRAD_BOUND."""
    batch = train_batch(cfg32, TRAIN_B, TRAIN_S, dev, seed=1)
    p_loss, plain = loss_grads(cfg32, params32, batch, plain=True)
    k_loss, kern = counted("f32 L=4 kernel path", train_launches(cfg32),
                           totals, lambda: loss_grads(cfg32, params32, batch))
    log(f"[train] f32 L={cfg32.num_layers} B={TRAIN_B} S={TRAIN_S}: loss "
        f"kernel {k_loss:.6f} plain {p_loss:.6f}")
    grads_within("f32 kernel path vs plain path", kern, plain)
    del plain
    for remat in ("full", "dots"):
        loss, got = counted(
            f"f32 L=4 remat {remat}", train_launches(cfg32, remat=remat),
            totals, lambda: loss_grads(cfg32, params32, batch, remat=remat))
        log(f"[train] remat {remat}: loss {loss:.6f}")
        grads_within(f"f32 remat {remat} vs none", got, kern)
        del got
    loss, got = counted("f32 L=4 fused loss", train_launches(cfg32), totals,
                        lambda: loss_grads(cfg32, params32, batch,
                                           loss_impl="fused"))
    log(f"[train] fused loss {loss:.6f} vs dense {k_loss:.6f}")
    grads_within("f32 fused loss vs dense", got, kern)


def train_checkpoint_run(dev, cfg32, params32, totals):
    """Phase 12(f): one AdamW step at L = 4 f32, then params and optimizer
    state saved and loaded back bitwise; a step from the loaded state
    equals the step continued without saving, bitwise."""
    import shutil
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.checkpoint.store import flatten
    from repro_torch.models.transformer import get_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.runtime import train

    batch = train_batch(cfg32, TRAIN_B, TRAIN_S, dev, seed=2)
    opt = AdamW(lr=cosine_schedule(TRAIN_LR[0], TRAIN_LR[1], TRAIN_STEPS))
    step = train.make_train_step(get_model(cfg32), opt, device=dev)
    state = opt.init(params32)
    params32, state, _ = counted(
        "f32 L=4 step before the checkpoint", train_launches(cfg32), totals,
        lambda: step(params32, state, batch))
    path = ROOT / "build" / "train_checkpoint"
    tree = {"params": params32, "opt": state}
    try:
        t0 = time.perf_counter()
        save_checkpoint(str(path), tree, step=1)
        t1 = time.perf_counter()
        loaded, n = load_checkpoint(str(path), device=dev)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    nbytes = sum(t.numel() * t.element_size() for t in flatten(tree).values())
    same = n == 1 and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(flatten(loaded).values(), flatten(tree).values()))
    log(f"[train] checkpoint of {nbytes / 1e9:.2f} GB (params and AdamW "
        f"state, L={cfg32.num_layers} f32): save {t1 - t0:.1f} s, load "
        f"{t2 - t1:.1f} s, loaded == saved bitwise: {same}")
    if not same:
        raise AssertionError("checkpoint: a leaf did not load back bitwise")
    runs = []
    for p, s in ((params32, state), (loaded["params"], loaded["opt"])):
        runs.append(counted("f32 L=4 step after the checkpoint",
                            train_launches(cfg32), totals,
                            lambda: step(p, s, batch)))
    (p1, s1, m1), (p2, s2, m2) = runs
    same = float(m1["loss"]) == float(m2["loss"]) and all(
        torch.equal(a, b) for a, b in zip(
            flatten({"p": p1, "s": s1}).values(),
            flatten({"p": p2, "s": s2}).values()))
    log(f"[train] step from the loaded state == the step continued: {same} "
        f"(loss {float(m1['loss']):.6f})")
    if not same:
        raise AssertionError("checkpoint: the resumed step differs")


def train_bf16_compare(dev, cfg, params, batch, totals):
    """Phase 12(b): one full-depth bf16 gradient on the kernel path against
    the plain path's, beside the yardstick (the plain path with f64
    attention): the loss difference and each leaf's cosine and relative
    norm error; the worst leaf's cosine held to GRAD_COS_FLOOR, or within
    YARDSTICK_MARGIN of the yardstick's."""
    p_loss, plain = loss_grads(cfg, params, batch, plain=True)
    k_loss, kern = counted(f"bf16 L={cfg.num_layers} kernel path",
                           train_launches(cfg), totals,
                           lambda: loss_grads(cfg, params, batch))
    k_cos = grad_agreement(kern, plain)
    del kern
    y_loss, yard = exact_attention(
        lambda: loss_grads(cfg, params, batch, plain=True))
    y_cos = grad_agreement(yard, plain)
    del yard, plain
    for what, loss, (c, c_at, r, r_at) in (("kernel path", k_loss, k_cos),
                                          ("yardstick", y_loss, y_cos)):
        log(f"[train] bf16 L={cfg.num_layers} {what} vs plain: loss "
            f"{loss:.6f} vs {p_loss:.6f} (diff {loss - p_loss:+.3e}); worst "
            f"leaf cosine {c:.6f} ({c_at}), worst relative norm error "
            f"{r:.3e} ({r_at})")
    floor = min(GRAD_COS_FLOOR, y_cos[0] - YARDSTICK_MARGIN)
    if not k_cos[0] >= floor:
        raise AssertionError(f"bf16 gradients: worst cosine {k_cos[0]} < "
                             f"{floor}")
    return k_cos, y_cos


def window_busy_us(prof, label: str) -> float:
    """Device busy (us) inside the host span of the ``label`` range: the
    union of the card's kernel and copy intervals clipped to it.  Exact
    when the range ends with a synchronise (its kernels then run inside
    it)."""
    host = [e for e in prof.events() if e.name == label and not _on_card(e)]
    a, b = host[0].time_range.start, host[0].time_range.end
    return _union_us((max(e.time_range.start, a), min(e.time_range.end, b))
                     for e in prof.events() if _work_on_card(e)
                     and e.time_range.end > a and e.time_range.start < b)


def fwd_bwd_ms(kernel, plain, args, ups):
    """Device ms (CUDA events, ``bench``) of ``kernel(*args)`` and of its
    backward as kernels.grad runs it: ``plain(*args)`` recomputed on the
    floating-point arguments and differentiated against ``ups``."""
    def backward(*args):
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_() if a.is_floating_point()
                      else a for a in args]
            outs = plain(*leaves)
            torch.autograd.grad(
                outs if isinstance(outs, tuple) else (outs,),
                [a for a in leaves if a.requires_grad], ups)
    return (bench(kernel, [args], iters=20),
            bench(backward, [args], iters=5, warmup=2))


def train_attention_ms(dev, cfg):
    """B2 at the training shape (q [TRAIN_B, TRAIN_S, Hq, D] bf16,
    causal): (forward ms, backward ms) by ``fwd_bwd_ms``."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(dev).manual_seed(4)
    shape = (TRAIN_B, TRAIN_S, cfg.num_heads, cfg.head_dim)
    kv = (TRAIN_B, TRAIN_S, cfg.num_kv_heads, cfg.head_dim)
    q, k, v, up = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
                   for s in (shape, kv, kv, shape))
    off = torch.zeros(TRAIN_B, dtype=torch.int32, device=dev)
    kl = torch.full((TRAIN_B,), TRAIN_S, dtype=torch.int32, device=dev)
    return fwd_bwd_ms(fops.flash_attention_cuda, flash_attention_ref,
                      (q, k, v, off, kl), (up,))


def train_wkv6_ms(dev, cfg, B: int, S: int):
    """B10 at the ssm family's training shape (r/k/v/w [B, S, H, hs] in
    the config's type, the kernel ops.wkv6 picks): (forward ms, backward
    ms) by ``fwd_bwd_ms`` (the backward through that kernel's plain
    form)."""
    from repro_torch.kernels.rwkv6_scan import ops as wops
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunk_ref, wkv6_ref
    from repro_torch.models.layers import torch_dtype
    H, hs = cfg.num_heads, cfg.ssm.head_size
    dt = torch_dtype(cfg.dtype)
    g = torch.Generator(dev).manual_seed(5)
    r, k, v, y_up = [(0.5 * torch.randn((B, S, H, hs), generator=g,
                                        device=dev)).to(dt)
                      for _ in range(4)]
    w = (0.8 + 0.199 * torch.rand((B, S, H, hs), generator=g,
                                  device=dev)).to(dt)
    u = 0.3 * torch.randn((H, hs), generator=g, device=dev)
    state = torch.zeros((B, H, hs, hs), device=dev)
    chunk = wops.kernel_chunk(B, S, H, hs)
    ms = fwd_bwd_ms(
        lambda *a: wops.wkv6_cuda(*a, chunk=chunk),
        wkv6_chunk_ref if chunk else wkv6_ref, (r, k, v, w, u, state),
        (y_up, torch.zeros_like(state)))
    return ms, "chunked" if chunk else "per-step"


def train_steps_run(dev, smi, cfg, params, batch, totals):
    """Phase 12(c)–(e): TRAIN_STEPS steps on one fixed batch, bf16 at full
    depth; the loss must fall and every value stay finite.  Steps 1 to
    TRAIN_STEPS − 1 are make_train_step calls, each with the forward's
    launches.  The last, profiled, runs the step's three parts as
    make_train_step does (loss_and_grads, then AdamW.update) with the
    card synchronised at the end of each ``train.*`` range, so that each
    range's span holds its kernels: its device ms is the union of the
    kernel intervals inside it (``window_busy_us``), and the backward is
    seen to launch no hand-written kernel.  Reported: host wall (the
    unprofiled steps'), device busy, idle share, the three ranges' device
    ms, B2's forward beside its backward (``train_attention_ms``), tokens
    per second and peak device memory."""
    import math
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.checkpoint.store import flatten, unflatten
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import get_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.runtime import train

    opt = AdamW(lr=cosine_schedule(TRAIN_LR[0], TRAIN_LR[1], TRAIN_STEPS))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state = opt.init(params)
    step = train.make_train_step(get_model(cfg), opt, device=dev)
    history, walls = [], []
    for i in range(TRAIN_STEPS - 1):
        t0 = time.perf_counter()
        params, state, m = counted(
            f"train step {i + 1}", train_launches(cfg), totals,
            lambda: step(params, state, batch))
        walls.append(1e3 * (time.perf_counter() - t0))
        history.append({k: float(v) for k, v in m.items()})
    loss_fn = train.make_loss_fn(get_model(cfg))
    live = {k: p.detach().requires_grad_()
            for k, p in flatten(params).items()}
    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("train.fwd"), torch.enable_grad():
            loss, metrics = loss_fn(unflatten(live), batch)
            torch.cuda.synchronize()
        fwd_counts = dict(_build.LAUNCHES)
        with record_function("train.bwd"):
            grads = torch.autograd.grad(loss, list(live.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
            torch.cuda.synchronize()
        bwd_counts = dict(_build.LAUNCHES)
        with record_function("train.opt"):
            params, state, om = opt.update(
                unflatten(dict(zip(live, grads))), state, params)
            torch.cuda.synchronize()
    del grads
    log(f"  launches train step {TRAIN_STEPS} (profiled): forward "
        f"{ {k: n for k, n in fwd_counts.items() if n} }, after the "
        f"backward {'the same' if bwd_counts == fwd_counts else bwd_counts}")
    if fwd_counts != train_launches(cfg) or bwd_counts != fwd_counts:
        raise AssertionError("training step: launches off the formula, or "
                             "a hand-written kernel in the backward")
    for k in totals:
        totals[k] += fwd_counts[k]
    history.append({k: float(v.detach()) for k, v in
                    {"loss": loss, **metrics, **om}.items()})
    for i, h in enumerate(history):
        log(f"[train] step {i + 1}: loss {h['loss']:.4f} grad_norm "
            f"{h['grad_norm']:.4f} lr {h['lr']:.3e}")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    finite = all(math.isfinite(v) for h in history for v in h.values())
    falls = history[-1]["loss"] < history[0]["loss"]
    log(f"[train] {TRAIN_STEPS} steps: loss {history[0]['loss']:.4f} -> "
        f"{history[-1]['loss']:.4f} (falls: {falls}), all finite: {finite}; "
        f"peak device memory {peak:.2f} GB (reckoned ~{TRAIN_MEMORY_GB})")
    if not (finite and falls):
        raise AssertionError("training: the loss did not fall or a value "
                             "is not finite")
    del state
    wall = sorted(walls[1:])[len(walls[1:]) // 2]
    busy_us, summed_us = device_busy_us(prof)
    if busy_us <= 0:
        log(f"[train step] host wall {wall:.3f} ms (median of steps 2–"
            f"{TRAIN_STEPS - 1}); device busy: not measured")
        MEASURED[ROOFLINE_STEPS[3]] = wall, None
        return
    fwd_ms, bwd_ms = train_attention_ms(dev, cfg)
    busy = busy_us / 1e3
    parts = {lab: window_busy_us(prof, lab) / 1e3
             for lab in ("train.fwd", "train.bwd", "train.opt")}
    MEASURED[ROOFLINE_STEPS[3]] = wall, busy
    b2 = [e for e in device_events(prof) if "flash_prefill" in e.key]
    log(f"[train step] {cfg.name} bf16 B={TRAIN_B} S={TRAIN_S}: host wall "
        f"{wall:.3f} ms (median of steps 2–{TRAIN_STEPS - 1}, no profiler; "
        f"all: {', '.join(f'{w:.1f}' for w in walls)}), device busy "
        f"{busy:.3f} ms (profiled step, union; sum {summed_us / 1e3:.3f}), "
        f"idle share {1 - busy / wall:.3f}; "
        f"{TRAIN_B * TRAIN_S / wall * 1e3:.0f} tokens/s ({smi})")
    log(f"[train step] device ms (synchronised ranges): "
        + ", ".join(f"{lab} {ms:.3f}" for lab, ms in parts.items())
        + f"; B2 in the step: {sum(e.self_device_time_total for e in b2) / 1e3:.3f} "
        f"ms in {sum(e.count for e in b2)} launches; one B2 at "
        f"q[{TRAIN_B},{TRAIN_S},{cfg.num_heads},{cfg.head_dim}]: forward "
        f"{fwd_ms:.4f} ms, its backward (flash_attention_ref recomputed and "
        f"differentiated) {bwd_ms:.4f} ms (CUDA events)")
    for e in sorted(device_events(prof),
                    key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    device {e.self_device_time_total / 1e3:8.3f} ms "
            f"{e.count:5d}x  {e.key[:90]}")


def train_family_run(dev, arch: str, B: int, S: int, totals):
    """Phase 12(g): one family at L = 2, full width, f32: the kernel path's
    gradient against the plain path's, every leaf within GRAD_BOUND."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import get_model
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              dtype="float32")
    torch.cuda.empty_cache()
    params = get_model(cfg).init(seed=0, device=dev)
    batch = train_batch(cfg, B, S, dev, seed=3)
    p_loss, plain = loss_grads(cfg, params, batch, plain=True)
    k_loss, kern = counted(f"{arch} f32 L=2 kernel path",
                           train_launches(cfg), totals,
                           lambda: loss_grads(cfg, params, batch))
    log(f"[train] {arch} f32 L=2 B={B} S={S}: loss kernel {k_loss:.6f} "
        f"plain {p_loss:.6f}")
    grads_within(f"{arch} f32 kernel path vs plain path", kern, plain)
    if cfg.family == "ssm":
        (fwd, bwd), which = train_wkv6_ms(dev, cfg, B, S)
        log(f"[train] {arch}: B10 ({which} kernel) at r[{B},{S},"
            f"{cfg.num_heads},{cfg.ssm.head_size}] {cfg.dtype}: forward "
            f"{fwd:.4f} ms, its backward (the {which} plain form recomputed "
            f"and differentiated) {bwd:.4f} ms (CUDA events)")


def train_phase(dev, smi, params):
    """Phase 12: the training path, (a)–(f) on llama32-3b (``params``,
    trained in place by (c); no later phase reads them), (g) the other
    families."""
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama_config()
    totals = {name: 0 for name in _build.LAUNCHES}
    times = []
    t_phase = t0 = time.perf_counter()

    def lap(what):
        nonlocal t0
        times.append(f"({what}) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    cfg32 = dataclasses.replace(cfg, num_layers=TRAIN_F32_LAYERS,
                                dtype="float32")
    params32 = get_model(cfg32).init(seed=3, device=dev)
    train_f32_run(dev, cfg32, params32, totals)
    lap("a")
    train_checkpoint_run(dev, cfg32, params32, totals)
    del params32
    lap("f")
    batch = train_batch(cfg, TRAIN_B, TRAIN_S, dev)
    train_bf16_compare(dev, cfg, params, batch, totals)
    lap("b")
    train_steps_run(dev, smi, cfg, params, batch, totals)
    lap("c-e")
    for arch, B, S in TRAIN_FAMILIES:
        train_family_run(dev, arch, B, S, totals)
    lap("g")
    log(f"[train phase] {', '.join(times)}, "
        f"{time.perf_counter() - t_phase:.1f} s; launches "
        f"{ {k: n for k, n in totals.items() if n} }")
    return totals


# ---------------------------------------------------------------------------
# phase 13: the roofline of the measured steps
# ---------------------------------------------------------------------------


def card_profile():
    """The card as a ``HardwareProfile``: its HBM rate and bf16 peak (the
    constants above); its links as H100_NODE's (one card has none)."""
    from repro_torch.config.base import H100_NODE
    return dataclasses.replace(H100_NODE, name="h100_sxm_card",
                               peak_flops=PEAK_FLOPS["bfloat16"],
                               hbm_bw=HBM_BYTES_PER_S)


def step_walks():
    """{step: (cfg, ShapeConfig, the walk)}: each step of ROOFLINE_STEPS
    as the breakdown measured it, run on meta tensors through the plain
    path under ``op_cost`` (the decode steps at the profiled steps'
    middle position: phase 3 profiles 8 steps from 138, phase 10 2 from
    132)."""
    from repro_torch.config.base import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.core import op_cost
    from repro_torch.launch import specs
    from repro_torch.models.transformer import get_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime import train

    meta = dict(dtype=torch.int32, device="meta")

    def decode(arch, depth):
        cfg = get_config(arch)
        model = get_model(cfg, plain=True)

        def walk():
            params, _ = specs.param_sds(cfg)
            cache = model.init_cache(4, 1024, device="meta")
            with torch.no_grad():
                return op_cost.count(model.decode_step, params, cache,
                                     torch.empty(4, **meta), depth,
                                     kv_rows=depth + 1)
        return cfg, ShapeConfig(f"decode@{depth}", depth, 4, "decode"), walk

    def prefill(arch, S):
        cfg = get_config(arch)
        model = get_model(cfg, plain=True)

        def walk():
            params, _ = specs.param_sds(cfg)
            with torch.no_grad():
                return op_cost.count(model.prefill, params,
                                     torch.empty(1, S, **meta), 1024)
        return cfg, ShapeConfig(f"prefill{S}", S, 1, "prefill"), walk

    def train_step(cfg, B, S):
        model = get_model(cfg, plain=True)

        def walk():
            params, _ = specs.param_sds(cfg)
            opt = AdamW()
            step = train.make_train_step(model, opt, device="meta")
            return op_cost.count(step, params, opt.init(params),
                                 {"tokens": torch.empty(B, S, **meta)})
        return cfg, ShapeConfig(f"train{B}x{S}", S, B, "train"), walk

    return dict(zip(ROOFLINE_STEPS, (
        decode(ARCH, 130 + 8 + 4), prefill(ARCH, 333),
        decode("deepseek-moe-16b", 130 + FAMILY_STEPS + FAMILY_STEPS // 2),
        train_step(llama_config(), TRAIN_B, TRAIN_S))))


def roofline_phase(smi):
    """Phase 13: for each step whose device busy an earlier phase measured
    (ROOFLINE_STEPS), the op walk's FLOPs and both byte counts on meta
    (``core.op_cost``: each kernel site one fused op) and
    ``roofline.analyze`` with H100_NODE and with the card's own
    constants: the three terms, the dominant one and the lower bound on
    the compulsory traffic, the measured busy over that bound, and the
    eager-traffic estimate's memory time beside it."""
    from repro_torch.config.base import H100_NODE
    from repro_torch.core import roofline

    t_phase = time.perf_counter()
    card = card_profile()
    for name, (cfg, shape, walk) in step_walks().items():
        t0 = time.perf_counter()
        cost = walk()
        wall, busy = MEASURED.get(name, (None, None))
        log(f"[roofline] {name}: {cost.flops / 1e12:.4f} TFLOP, "
            f"compulsory HBM traffic {cost.min_bytes / 1e9:.3f} GB, eager "
            f"estimate {cost.bytes / 1e9:.3f} GB (op walk on meta, "
            f"{time.perf_counter() - t0:.2f} s); measured host wall "
            + (f"{wall:.3f} ms, device busy "
               + (f"{busy:.3f} ms" if busy else "not measured")
               if wall else "not measured") + f" ({smi})")
        if not 0 < cost.min_bytes <= cost.bytes:
            raise AssertionError(
                f"roofline {name}: the compulsory traffic "
                f"{cost.min_bytes:.6g} B is not within (0, the eager "
                f"estimate {cost.bytes:.6g} B]")
        for hw in (H100_NODE, card):
            r = roofline.analyze(cfg, shape, "1 card", 1, cost.flops,
                                 cost.min_bytes, None, hw=hw)
            bound = r.step_time_lower_bound * 1e3
            eager = cost.bytes / hw.hbm_bw * 1e3
            log(f"[roofline]   {hw.name}: compute {r.compute_s * 1e3:.3f} "
                f"ms, memory {r.memory_s * 1e3:.3f} ms, collective "
                f"{r.collective_s * 1e3:.3f} ms, dominant {r.dominant}, "
                f"lower bound {bound:.3f} ms, useful {r.useful_ratio:.3f}; "
                f"the eager estimate's memory {eager:.3f} ms; "
                + (f"busy / bound {busy / bound:.2f}, busy / eager "
                   f"{busy / eager:.2f}" if busy else
                   "busy / bound: not measured"))
        for op, (calls, flops, nbytes) in cost.top(6):
            log(f"    {op:22s} {calls:6d} calls {flops / 1e9:10.1f} GFLOP "
                f"{nbytes / 1e9:9.3f} GB")
    log(f"[roofline phase] {time.perf_counter() - t_phase:.1f} s")


_RMS = "src/repro/kernels/rmsnorm/rmsnorm_kernel.py:25"
REPLACES = {
    "rmsnorm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu", _RMS),
    "add_rms_norm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu", _RMS),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_kernel.py:80"),
    "decode_attention": (
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_kernel.py:56"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/paged_kernel.py:70"),
    # the int4 wire's fused kernels stand for B7 (nibble_pack_pallas, :113)
    # and B8 (nibble_unpack_pallas, :141), dequantize_add_rms_norm for B9 at
    # the norm sites of the TP path; the standalone B9 dequantizes the sum a
    # pipeline stage ships on the int8/fp8 step; FUSES names all they cover
    **{name: ("src/repro_torch/kernels/quant_collective/csrc/"
              "quant_collective.cu",
              f"src/repro/kernels/quant_collective/quant_kernel.py:{line}")
       for name, line in (("chunk_amax", 44), ("chunk_quantize", 75),
                          ("chunk_dequantize", 167),
                          ("dequantize_add_rms_norm", 167),
                          ("chunk_quantize_pack", 113),
                          ("nibble_reduce_requant", 141),
                          ("nibble_unpack_dequantize", 141))},
    "wkv6": ("src/repro_torch/kernels/rwkv6_scan/csrc/wkv6.cu",
             "src/repro/kernels/rwkv6_scan/wkv6_kernel.py:55"),
}


_QK = "src/repro/kernels/quant_collective/quant_kernel.py"
_QO = "src/repro/kernels/quant_collective/ops.py"     # scales_from_amax
FUSES = {
    "add_rms_norm": ["src/repro/models/blocks.py:124", _RMS],
    "dequantize_add_rms_norm": [f"{_QK}:167",
                                "src/repro/core/parallel_exec.py:211", _RMS],
    "chunk_quantize": [f"{_QK}:75", f"{_QO}:103"],
    "chunk_quantize_pack": [f"{_QK}:75", f"{_QK}:113", f"{_QO}:103",
                            "src/repro/core/parallel_exec.py:183"],
    "nibble_reduce_requant": [f"{_QK}:141",
                              "src/repro/core/parallel_exec.py:176",
                              f"{_QK}:113"],
    "nibble_unpack_dequantize": [f"{_QK}:141", f"{_QK}:167"],
}


# ---------------------------------------------------------------------------
# phase 14: the sharded step on a DeviceMesh
# ---------------------------------------------------------------------------

SHARDED_DRYRUNS = (("granite-8b", "prefill_32k"),
                   ("internlm2-1.8b", "decode_32k"),
                   ("deepseek-moe-16b", "decode_32k"),
                   ("deepseek-moe-16b", "decode_32k", "moe_local"),
                   ("mixtral-8x22b", "prefill_32k", "moe_local_fsdp"),
                   ("rwkv6-7b", "prefill_32k"),
                   ("hymba-1.5b", "decode_32k"))
SHARDED_PROMPT, SHARDED_NEW = 333, 16
# (d): the moe, ssm and hybrid families on the (1, 1) mesh
SHARDED_FAMILIES = ("rwkv6-7b", "deepseek-moe-16b", "hymba-1.5b")
SHARDED_FAMILY_PROMPTS, SHARDED_FAMILY_NEW = (2, 64), 8


class HeadLogits:
    """Keeps every logits tensor a model's head returns (the local block
    of a DTensor), so two runs compare logits as well as tokens."""

    def __init__(self, model):
        self.out = []
        self.model, self.head = model, model._head

        def kept(params, x, **kw):
            logits = self.head(params, x, **kw)
            self.out.append(logits.to_local() if hasattr(logits, "to_local")
                            else logits)
            return logits
        model._head = kept

    def restore(self):
        self.model._head = self.head
        return self.out


def sharded_phase(dev, smi):
    """Phase 14 (module doc): the dry runs on meta, then the sharded serve
    step on a one-rank NCCL group against the unsharded kernel path."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.core import step_comm
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as sp
    from repro_torch.models.transformer import get_model, greedy_tokens
    from repro_torch.runtime import meshctx
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.engine import InferenceEngine, make_serve_step

    t_phase = time.perf_counter()
    # (a) full width on meta, 256 fake ranks
    for arch, shape, *variant in SHARDED_DRYRUNS:
        t0 = time.perf_counter()
        rec = dryrun.run_one(arch, shape, False, *variant)
        if rec["status"] != "ok" or not rec["collectives_match"]:
            raise AssertionError(f"dry run {arch} {shape} {variant}: "
                                 f"{rec['status']}, collectives "
                                 f"{rec.get('collectives')} != "
                                 f"{rec.get('closed_form')}")
        seen = {k: [v["count"], v["msg_bytes"]]
                for k, v in rec["collectives"].items()}
        log(f"[sharded dry run] {arch} {shape} {rec['mesh']} in "
            f"{time.perf_counter() - t0:.1f} s: collectives "
            f"{json.dumps(seen)} == closed form; per chip "
            f"{rec['roofline']['flops_per_chip']:.6g} FLOPs, temp "
            f"{rec['memory_analysis']['temp_size_in_bytes']} B")
        log(f"[sharded dry run] roofline (H100_NODE, not measured) "
            f"{rec['roofline_row']}")
    dist.destroy_process_group()

    # (b) one rank of NCCL on the card, a (1, 1) mesh
    cfg = get_config(ARCH)
    L = cfg.num_layers
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    totals = {name: 0 for name in _build.LAUNCHES}
    try:
        dmesh = init_device_mesh("cuda", (1, 1),
                                 mesh_dim_names=("data", "model"))
        params = get_model(cfg).init(seed=0, device=dev)
        prompt = torch.randint(2, cfg.vocab_size, (1, SHARDED_PROMPT),
                               generator=torch.Generator().manual_seed(14)
                               ).to(dev)
        model = get_model(cfg)

        def generate(p):
            lg, cache, pos = model.prefill(p, prompt, 1024)
            tok = greedy_tokens(lg)
            toks, step = [tok], make_serve_step(model)
            for i in range(SHARDED_NEW):
                tok, cache = step(p, cache, tok, pos + i)
                toks.append(tok)
            return [t.to_local() if hasattr(t, "to_local") else t
                    for t in toks]

        expect = dict(passes=SHARDED_NEW + 1, flash=1, decode=SHARDED_NEW,
                      paged=0)
        kept = HeadLogits(model)
        t0 = time.perf_counter()
        want = drive_counted("unsharded", lambda: generate(params), totals,
                             L, **expect)
        wall_plain = time.perf_counter() - t0
        want_logits = kept.restore()
        engine = drive_counted(
            "engine", lambda: InferenceEngine(
                cfg, params, max_len=1024, decode_chunk=1, device=dev
            ).generate(prompt, max_new_tokens=SHARDED_NEW + 1), totals, L,
            **expect)
        if not torch.equal(engine, torch.stack(want, 1)):
            raise AssertionError("unsharded tokens != InferenceEngine's")
        _, pspecs = sp.param_sds(cfg, sh.mesh_shape(dmesh))
        placed = sh.distribute(params, pspecs, dmesh)
        meshctx.set_device_mesh(dmesh)
        try:
            kept = HeadLogits(model)
            t0 = time.perf_counter()
            got, log_ = drive_counted(
                "sharded", lambda: step_comm.record(generate, placed),
                totals, L, grad_mode=torch.no_grad, **expect)
            wall = time.perf_counter() - t0
            got_logits = kept.restore()
        finally:
            meshctx.set_device_mesh(None)
        same_tokens = all(torch.equal(a, b) for a, b in zip(got, want))
        same_logits = len(got_logits) == len(want_logits) and all(
            torch.equal(a, b) for a, b in zip(got_logits, want_logits))
        named = [(c.kind, c.group_size, c.out_bytes) for c in log_]
        log(f"[sharded] {ARCH} bf16 on a (1, 1) DeviceMesh over NCCL: "
            f"prefill {SHARDED_PROMPT} + {SHARDED_NEW} decode steps in "
            f"{wall:.3f} s host wall (unsharded {wall_plain:.3f} s); "
            f"tokens bitwise == unsharded: {same_tokens}, "
            f"logits ({len(got_logits)} rows) bitwise: {same_logits}; "
            f"collectives read off the step: {named or 'none'} ({smi})")
        if not (same_tokens and same_logits):
            raise AssertionError("sharded step != unsharded kernel path")
        wide = [c for c in log_ if c.group_size > 1]
        if wide:
            raise AssertionError(f"collectives over more than one device on "
                                 f"a (1, 1) mesh: {wide}")
        del params, placed
        torch.cuda.empty_cache()
        for arch in SHARDED_FAMILIES:
            sharded_family_run(dev, smi, arch, dmesh, totals)
    finally:
        dist.destroy_process_group()
    split_pass_check(dev)
    log(f"[sharded] phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return totals


def sharded_family_run(dev, smi, arch: str, dmesh, totals):
    """Phase 14(d) (module doc): one family at full width on the (1, 1)
    mesh against its unsharded kernel path (the moe family on both
    dispatches)."""
    from repro_torch.configs import get_config
    from repro_torch.core import step_comm
    from repro_torch.launch import specs as sp
    from repro_torch.models.transformer import get_model, greedy_tokens
    from repro_torch.runtime import meshctx
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.engine import make_serve_step

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(arch)
    L = cfg.num_layers
    model = get_model(cfg)
    params = model.init(seed=0, device=dev)
    prompt = torch.randint(2, cfg.vocab_size, SHARDED_FAMILY_PROMPTS,
                           generator=torch.Generator().manual_seed(14)
                           ).to(dev)
    max_len = SHARDED_FAMILY_PROMPTS[1] + SHARDED_FAMILY_NEW + 1

    def generate(p, model=model):
        lg, cache, pos = model.prefill(p, prompt, max_len)
        tok = greedy_tokens(lg)
        toks, step = [tok], make_serve_step(model)
        for i in range(SHARDED_FAMILY_NEW):
            tok, cache = step(p, cache, tok, pos + i)
            toks.append(tok)
        return [t.to_local() if hasattr(t, "to_local") else t
                for t in toks]

    passes = SHARDED_FAMILY_NEW + 1
    if cfg.family == "ssm":
        expect = dict(passes=passes, flash=0, decode=0, paged=0,
                      scan=passes)
    else:
        expect = dict(passes=passes, flash=1, decode=SHARDED_FAMILY_NEW,
                      paged=0, branch=2 if cfg.family == "hybrid" else 0)
    kept = HeadLogits(model)
    t1 = time.perf_counter()
    want = drive_counted(f"{arch} unsharded", lambda: generate(params),
                         totals, L, **expect)
    wall_plain = time.perf_counter() - t1
    want_logits = kept.restore()
    _, pspecs = sp.param_sds(cfg, sh.mesh_shape(dmesh))
    placed = sh.distribute(params, pspecs, dmesh)
    runs = [(arch, model)]
    if cfg.family == "moe":     # the local dispatch, the same parameters
        runs.append((f"{arch} moe_dispatch=local", get_model(
            dataclasses.replace(cfg, moe_dispatch="local"))))
    for what, m in runs:
        meshctx.set_device_mesh(dmesh)
        try:
            kept = HeadLogits(m)
            t1 = time.perf_counter()
            got, log_ = drive_counted(
                f"{what} sharded",
                lambda: step_comm.record(generate, placed, m),
                totals, L, grad_mode=torch.no_grad, **expect)
            wall = time.perf_counter() - t1
            got_logits = kept.restore()
        finally:
            meshctx.set_device_mesh(None)
        same_tokens = all(torch.equal(a, b) for a, b in zip(got, want))
        same_logits = len(got_logits) == len(want_logits) and all(
            torch.equal(a, b) for a, b in zip(got_logits, want_logits))
        named = sorted({(c.kind, c.group_size) for c in log_})
        log(f"[sharded] {what} bf16 on a (1, 1) DeviceMesh over NCCL: "
            f"{SHARDED_FAMILY_PROMPTS[0]} prompts of "
            f"{SHARDED_FAMILY_PROMPTS[1]} + {SHARDED_FAMILY_NEW} decode "
            f"steps in {wall:.3f} s host wall (unsharded {wall_plain:.3f} "
            f"s); tokens bitwise == unsharded: {same_tokens}, logits "
            f"({len(got_logits)} rows) bitwise: {same_logits}; collectives "
            f"read off the step (kind, group size): {named or 'none'}; "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
            f"{time.perf_counter() - t0:.1f} s with init ({smi})")
        if not (same_tokens and same_logits):
            raise AssertionError(f"{what}: sharded step != unsharded "
                                 f"kernel path")
        wide = [c for c in log_ if c.group_size > 1]
        if wide:
            raise AssertionError(f"{what}: collectives over more than one "
                                 f"device on a (1, 1) mesh: {wide}")
    del params, placed
    torch.cuda.empty_cache()


def split_pass_check(dev):
    """Phase 14(c) (module doc): B3's split pass alone against
    ``split_partials`` on the live splits of one rank's cache rows."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.decode_attention.ops import (
        SPLIT_KEYS, decode_attention_partials_cuda)

    cfg = get_config("internlm2-1.8b")
    b, rows = 128 // 16, 32768 // 16
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(14)
    lens = torch.tensor([0, 1, 127, 128, 129, 1000, 2047, 2048],
                        dtype=torch.int32, device=dev)
    live = (torch.arange(rows // SPLIT_KEYS, device=dev)[None]
            < (-(-lens.long() // SPLIT_KEYS))[:, None])[:, None]
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).replace("torch.", "")
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
                   for shape in ((b, Hq, D), (b, rows, Hkv, D),
                                 (b, rows, Hkv, D)))
        got = decode_attention_partials_cuda(q, k, v, lens)
        want = dref.split_partials(q, k, v, lens, SPLIT_KEYS)
        for name, a, w in zip(("m", "l", "acc"), got, want):
            sel = live.expand(a.shape[:3])
            compare(f"B3 split pass alone {name} kv[{b},{rows},{Hkv},{D}] "
                    f"{dname}", a[sel], w[sel], "float32")
        del q, k, v, got, want


# ---------------------------------------------------------------------------
# phase 15: the examples and the paper's tables on the card
# ---------------------------------------------------------------------------

# the hand-written kernels each example must launch on the card (its
# other launches are counted too)
EXAMPLE_KERNELS = {
    "serve_demo": ("rmsnorm", "add_rms_norm", "flash_attention",
                   "decode_attention"),
    "comm_study": ("rmsnorm", "add_rms_norm", "flash_attention",
                   "decode_attention"),
    "quant_demo": ("chunk_amax", "chunk_quantize", "dequantize_add_rms_norm",
                   "decode_attention"),
    "quickstart": ("rmsnorm", "add_rms_norm", "flash_attention",
                   "decode_attention"),
    "prefix_demo": ("flash_attention", "paged_decode_attention"),
    "disagg_demo": ("flash_attention", "paged_decode_attention"),
    "chaos_demo": ("flash_attention", "paged_decode_attention"),
}


def example_run(dev, smi, name, totals, fn):
    """One example's ``run``: its launches counted into ``totals`` (each
    of EXAMPLE_KERNELS[name] at least once), its seconds logged."""
    t0 = time.perf_counter()
    with count_into(totals) as counts:
        out = fn()
    wall = time.perf_counter() - t0
    missing = [k for k in EXAMPLE_KERNELS[name] if counts[k] < 1]
    log(f"[example {name}] {wall:.2f} s; launches "
        f"{ {k: n for k, n in counts.items() if n} } ({smi})")
    if missing:
        raise AssertionError(f"{name}: {missing} never launched")
    return out


def examples_phase(dev, smi):
    """Phase 15: the seven examples' ``run`` at the full width of
    llama32-3b on LLAMA_DEPTH layers (bf16 from seed 0; the three
    token-identity examples in f32), each held to its own invariants
    (quant_demo, at t = 2 on these layers, to QUANT_TOLERANCE, which it
    meets here where phase 5's t = 4 misses it, ROADMAP C6),
    then ``paper.run`` on the card's host, every Fig. 4 row EXACT."""
    import io

    from repro_torch.configs import get_config
    from repro_torch.examples import (chaos_demo, comm_study, disagg_demo,
                                      prefix_demo, quant_demo, quickstart,
                                      serve_demo)
    from repro_torch.kernels import _build
    from repro_torch.kernels.quant_collective import QUANT_TOLERANCE
    from repro_torch.models.transformer import get_model
    from repro_torch.paper import run as paper_run

    torch.backends.cuda.matmul.allow_tf32 = False
    totals = {name: 0 for name in _build.LAUNCHES}
    t_phase = time.perf_counter()
    cfg = llama_config()
    params = get_model(cfg).init(seed=0, device=dev)

    out = example_run(dev, smi, "serve_demo", totals,
                      lambda: serve_demo.run(cfg, params, dev))
    serve_demo.check(out)
    s, pred = out["summary"], out["predicted"]
    log(f"[example serve_demo] {len(out['trace'])} requests at 4 req/s, 4 "
        f"slots: throughput {s['throughput_tok_s']:.1f} tok/s, mean TTFT "
        f"{s['ttft_mean_s'] * 1e3:.1f} ms, TPOT {s['tpot_mean_s'] * 1e3:.2f}"
        f" ms, E2E {s['e2e_mean_s']:.3f} s (smoke reading, not a cell); "
        f"predict_slo (s_p={out['s_p']}, s_d={out['s_d']}, "
        f"{cfg.num_layers} layers): {pred.row().strip()} ({smi})")

    out = example_run(dev, smi, "comm_study", totals,
                      lambda: comm_study.run(cfg, params, dev))
    comm_study.check(out)
    log(f"[example comm_study] PipelineEngine (t=1, p=2) b={out['b']}: "
        f"measured == pp_comm_ops {out['rows']}")

    out = example_run(dev, smi, "quant_demo", totals,
                      lambda: quant_demo.run(cfg, params, dev))
    tol = QUANT_TOLERANCE[out["quant"]]
    quant_demo.check(out, tol["token_match_floor"],
                     tol["logit_drift_ceiling"])
    # the closed form's wire: each decode's logged collectives (no
    # ceiling here: the unquantized logits gather keeps the quantized
    # step's wire near 0.8 of the full-width one at this width)
    quant_demo.check_wire(out)
    log(f"[example quant_demo] t={out['tp']} B={out['batch']} "
        f"{out['tokens']} tokens {out['quant']}: top-1 match "
        f"{out['match']:.4f} drift {out['drift']:.4f} (QUANT_TOLERANCE "
        f"{tol['token_match_floor']} / {tol['logit_drift_ceiling']}); "
        f"decode wire/step {out['wire_b']:.0f} -> {out['wire_q']:.0f} B, "
        f"logged == comm_ops_for (b={out['b']}, the "
        f"logits gather unquantized; per-layer AR ratio "
        f"{out['ratio']:.4f}); tokens/s {out['tps_b']:.1f} full-width -> "
        f"{out['tps_q']:.1f} quantized (smoke reading, not a cell) ({smi})")

    # last of the bf16 runs: its AdamW step updates the weights in place
    out = example_run(dev, smi, "quickstart", totals,
                      lambda: quickstart.run(cfg, params, dev))
    quickstart.check(cfg, out)
    log(f"[example quickstart] logits {tuple(out['logits'].shape)}, train "
        f"step loss {out['loss']:.4f} grad_norm {out['grad_norm']:.3f}, "
        f"generated {out['generated'][0].tolist()}")
    del params, out
    torch.cuda.empty_cache()

    # the examples whose invariant is a token stream identical to a solo
    # or fault-free run: f32, as phase 9 holds the same identities
    # (failure_f32_run, disagg_run's cfg32); bf16 does not (ROADMAP C12)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = get_model(cfg32).init(seed=0, device=dev)
    for name, mod, kw in (
            ("prefix_demo", prefix_demo, {}), ("chaos_demo", chaos_demo, {}),
            ("disagg_demo", disagg_demo,
             {"planner_cfg": get_config(ARCH)})):
        out = example_run(dev, smi, name, totals,
                          lambda mod=mod, kw=kw: mod.run(cfg32, p32, dev,
                                                         **kw))
        mod.check(out)
        log(f"[example {name}] f32 L={cfg32.num_layers}: invariants held "
            f"(streams identical to the solo / fault-free runs, no page "
            f"leaked)")
    del p32

    t0 = time.perf_counter()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            paper_run.main()
    except SystemExit as exc:               # a module of the run failed
        raise AssertionError("repro_torch.paper.run failed") from exc
    rows = buf.getvalue().splitlines()
    fig4 = [r for r in rows if r.startswith("fig4/")]
    log(f"[paper] repro_torch.paper.run: {len(rows) - 1} rows in "
        f"{time.perf_counter() - t0:.1f} s on the card's host")
    for r in fig4:
        log(f"[paper] {r}")
    if len(fig4) != 3 or not all(r.endswith("match=EXACT") for r in fig4):
        raise AssertionError(f"Fig. 4 rows not EXACT: {fig4}")
    log(f"[examples phase] {time.perf_counter() - t_phase:.1f} s; launches "
        f"{totals}")
    return totals


def timed(phase, *args):
    """``phase(*args)``, its seconds logged."""
    t0 = time.perf_counter()
    out = phase(*args)
    progress(f"[phase] {phase.__name__} in {time.perf_counter() - t0:.1f} s")
    return out


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
    for phase in (norm_kernel_phase, quant_kernel_phase, wkv6_kernel_phase):
        more_rows, more_times = phase(dev, args.iters)
        rows.update(more_rows)
        times.update(more_times)
    cp_kernel_rows(dev, args.iters, rows, times)
    encoder_vlm_kernel_rows(dev, args.iters, rows, times)
    if args.kernels_only:
        return 0
    progress(f"[phase] 1-2 in {time.perf_counter() - t_start:.1f} s")
    params, launches = timed(serving_phase, dev, smi)
    params = cut_depth(params)
    prompt, kernel_rows = timed(model_compare_phase, dev, params)
    counted = [
        (tp_phase, (dev, smi, params, prompt, kernel_rows)),
        (pp_phase, (dev, smi, params)),
        (cp_phase, (dev, smi, params, prompt, kernel_rows)),
        (failure_phase, (dev, smi, params)),
        (train_phase, (dev, smi, params))]
    for phase, phase_args in counted:
        for name, n in timed(phase, *phase_args).items():
            launches[name] += n
    del params, prompt, kernel_rows, counted, phase_args
    for phase, phase_args in ((rwkv_phase, (dev, smi)),
                              (families_phase, (dev, smi, rows)),
                              (encoder_vlm_phase, (dev, smi))):
        for name, n in timed(phase, *phase_args).items():
            launches[name] += n
    timed(roofline_phase, smi)
    for name, n in timed(sharded_phase, dev, smi).items():
        launches[name] += n
    for name, n in timed(examples_phase, dev, smi).items():
        launches[name] += n

    table = []
    for name, (source, replaces) in REPLACES.items():
        t = times[name]["bfloat16"]
        table.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(rows[name][d]["err"] for d in rows[name]),
            ms=t["kernel"], kernel_ms=t["kernel"], plain_ms=t["plain"],
            bound_ms=t["bound"], bound_by=t["by"], library_ms=t["library"],
            shape=rows[name]["bfloat16"]["shape"], dtype="bfloat16",
            **({"launch_floor_ms": t["floor"]} if "floor" in t else {}),
            **({"unfused_chain_ms": t["chain"]} if t.get("chain") else {}),
            **({"grid_floor_ms": t["grid_floor"]} if "grid_floor" in t
               else {}),
            **({"no_scales_write_ms": t["no_scales_ms"]}
               if "no_scales_ms" in t else {}),
            **({"allreduce_ms": t["allreduce"]} if "allreduce" in t else {}),
            **({"ms_overlapped_by_pdl": True} if t.get("overlapped")
               else {}),
            **({"fuses": FUSES[name]} if name in FUSES else {}),
            **({"cp_shard": {
                "shape": t["cp_shard"]["shape"], "ms": t["cp_shard"]["kernel"],
                "plain_ms": t["cp_shard"]["plain"],
                "bound_ms": t["cp_shard"]["bound"],
                "bound_by": t["cp_shard"]["by"],
                "library_ms": t["cp_shard"]["library"]}}
               if "cp_shard" in t else {}),
            **({"shapes": {what: {
                "shape": r["shape"], "ms": r["kernel"],
                "plain_ms": r["plain"], "bound_ms": r["bound"],
                "bound_by": r["by"], "library_ms": r["library"],
                "library_call": r["library_call"]}
                for what, r in t["shapes"].items()}}
               if "shapes" in t else {})))
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
