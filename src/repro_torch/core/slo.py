"""α–β SLO predictor: TTFT / TPOT / E2E per parallelism layout (paper §V-C).

The paper *measures* SLOs on 4×H100 nodes running vLLM V0 (eager mode, custom
allreduce off).  This module is the analytical counterpart: per-phase
compute/memory terms + per-collective α–β latencies + engine overheads.  It
is the JAX package's ``repro.core.slo`` with the imports renamed.

Calibration: the engine-overhead constants below are FITTED to the paper's
published curves (Figs 8–10) and documented as such — the paper itself pairs
analytical models with measured validation; we invert the direction.  The
calibrated model reproduces (asserted in tests/test_slo.py):
  * Fig 8 — TTFT monotonically improves TP2→TP4→TP8; TPOT/E2E degrade badly
    once the TP group crosses nodes (TP8),
  * Fig 9 — PP TTFT grows with pipeline depth; TPOT jumps when a pipeline
    link crosses nodes (PP8),
  * Fig 10 — TP8 beats PP8 and hybrids on TTFT for Llama-2-13B.
Known residual: the paper's catastrophic TP4×PP2 outlier (15.15 s E2E) is a
configuration pathology the paper reports without a mechanism; the analytical
model predicts it close to TP2×PP4, not catastrophic (EXPERIMENTS.md §SLO).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.config.base import HardwareProfile, H100_NODE, ModelConfig
from repro_torch.core.commodel import DEFAULT_QUANT_CHUNK, CommOp, comm_ops_for, \
    cp_comm_ops, cp_shard_len, kv_handoff_ops


@dataclasses.dataclass(frozen=True)
class EngineOverheads:
    """vLLM-V0-like engine constants (fitted to paper Figs 8–10)."""

    request_overhead: float = 10e-3       # scheduling + tokenize per request
    prefill_eff_base: float = 0.005       # eager-mode effective MFU @3.6B
    prefill_eff_ref_params: float = 3.6e9
    decode_hbm_eff: float = 1.0           # decode streams weights ~at HBM bw
    per_layer_launch: float = 20e-6       # per layer per decode step (eager)
    stage_overhead_prefill: float = 150e-3  # per pipeline stage per prefill
    stage_overhead_decode: float = 0.2e-3   # per stage per decode step
    cross_link_decode_overhead: float = 6e-3  # per cross-node pipeline link
    cp_round_overhead: float = 50e-6  # per CP ring round per layer: the
    #   eager-mode launch/sync of the blocking permute chain (DESIGN.md §9)
    #   — what makes CP pure overhead on short prompts, amortized on long


DEFAULT_OVERHEADS = EngineOverheads()


@dataclasses.dataclass
class SLOReport:
    ttft: float
    tpot: float
    e2e: float
    comm_volume: float
    breakdown: Dict[str, float]
    occupancy: float = 1.0

    def row(self) -> str:
        return (f"TTFT {self.ttft*1e3:8.1f} ms  TPOT {self.tpot*1e3:7.2f} ms  "
                f"E2E {self.e2e:6.2f} s  comm {self.comm_volume/2**20:8.1f} MiB")


def _prefill_eff(n_params: float, ov: EngineOverheads) -> float:
    return min(0.2, ov.prefill_eff_base
               * math.sqrt(n_params / ov.prefill_eff_ref_params))


def _collective_time(op: CommOp, hw: HardwareProfile, cross: bool) -> float:
    bw = hw.inter_bw if cross else hw.intra_bw
    alpha = hw.inter_alpha if cross else hw.intra_alpha
    return op.count * alpha + op.wire_bytes / bw


def split_p2p_count(count: int, p: int, cross_links: int):
    """Split a p2p call count between intra- and cross-node pipeline links.

    ``cross_links`` of the ``p - 1`` links cross nodes; rounding is guarded
    so the two parts are each in [0, count] and ALWAYS sum to ``count`` —
    the naive ``int(count * (1 - frac))`` truncation silently shifts calls
    from the intra to the (α-heavier) cross bucket.
    """
    if p <= 1 or cross_links <= 0:
        return count, 0
    frac_cross = min(cross_links / (p - 1), 1.0)
    cross = min(count, max(0, round(count * frac_cross)))
    return count - cross, cross


def predict_slo(cfg: ModelConfig, s_p: int, s_d: int, t: int = 1, p: int = 1,
                hw: HardwareProfile = H100_NODE,
                ov: EngineOverheads = DEFAULT_OVERHEADS,
                batch: int = 1, dtype_bytes: int = 2,
                c: int = 1, inflight: int = 1, quant: str = None,
                quant_chunk: int = DEFAULT_QUANT_CHUNK,
                hit_rate: float = 0.0,
                hit_len: int = None,
                handoff_pages: int = 0,
                page_size: int = 16) -> SLOReport:
    """Predict TTFT/TPOT/E2E for a (t, c, p) layout of one inference
    request.  Context parallelism (``c > 1``, DESIGN.md §9) divides the
    prefill compute over t·c workers and adds the per-layer ring latency
    (``commodel.cp_comm_ops``: 2L(c-1) permutes + 1 cp allreduce) to the
    prefill communication; decode terms are untouched — the cp workers
    replicate decode, so CP buys TTFT on long prompts and is pure overhead
    on short ones (and on TPOT always).

    ``inflight`` is the dynamic-schedule microbatch depth (DESIGN.md §11):
    with d groups in flight a p-stage pipeline keeps each stage busy
    ``occ = min(d, p)/p`` of the time, so the *per-request* decode cadence
    improves from one token per p stage-steps to one per ``p·occ`` —
    ``tpot_effective = tpot / (occ · p)`` with tpot the single-request
    serialized value.  At ``inflight=1`` every term is bitwise the old
    report (occ·p = 1 only when p = 1; for p > 1 occ = 1/p and
    tpot_effective = tpot exactly, since tpot already serializes stages).

    ``quant`` ("int8" | "fp8", DESIGN.md §12) prices the decode-phase
    per-layer TP allreduces at the quantized two-step decomposition
    (``comm_ops_for(quant=...)``).  Latency model: a ring allreduce IS a
    reduce-scatter + all-gather internally, and Flash Communication fuses
    the amax exchange into the quantize kernel's launch — so each
    quantized AR is charged ONE α (carried by its amax-allreduce row; the
    1-byte payload rows are bytes-only), the same launch cost as the
    full-width AR it replaces.  The win is therefore pure wire bytes
    (~w/b + scale overhead of the original), which lands exactly where
    the paper says TP hurts: bandwidth-bound decode at large t.

    ``hit_rate`` (DESIGN.md §13) prices cross-request prefix caching: a
    fraction ``hit_rate`` of requests find their first ``hit_len`` prompt
    positions in the index (default: the whole prompt minus the final
    position — a fully shared template) and prefill only the suffix, so
    their TTFT is the TTFT of a ``s_p - hit_len``-token request on the
    same layout.  The report mixes the cold and hit terms linearly;
    ``hit_rate=0`` is bitwise the uncached report.  Decode terms never
    move — the cache skips prefill only — which is exactly why the
    planner's ranking shifts under template-heavy traffic: layouts that
    buy prefill time (CP's ring, prefill-lean PP splits) lose their edge
    when prefill is mostly skipped, while decode-bound layouts keep
    theirs.

    ``handoff_pages`` (DESIGN.md §14) prices disaggregated admission: the
    request's prompt KV was prefilled on a SEPARATE pool and its full
    blocks cross the interconnect before this layout's decode starts —
    TTFT gains one cross-node α plus ``handoff_pages`` × page bytes at
    ``hw.inter_bw`` (``commodel.kv_handoff_ops``), and the bytes join
    ``comm_volume``.  ``handoff_pages=0`` is bitwise the colocated
    report."""
    if not 0.0 <= hit_rate <= 1.0:
        raise ValueError(f"hit_rate must be in [0, 1], got {hit_rate}")
    if handoff_pages < 0:
        raise ValueError(
            f"handoff_pages must be >= 0, got {handoff_pages}")
    if hit_rate > 0.0:
        hit = s_p - 1 if hit_len is None else int(hit_len)
        if not 1 <= hit < s_p:
            raise ValueError(
                f"hit_len must be in [1, s_p) — the final position is "
                f"always prefilled — got {hit} at s_p={s_p}")
        # the handoff term rides through both legs: mixing is linear, so
        # the constant addend survives exactly once
        cold = predict_slo(cfg, s_p, s_d, t, p, hw=hw, ov=ov, batch=batch,
                           dtype_bytes=dtype_bytes, c=c, inflight=inflight,
                           quant=quant, quant_chunk=quant_chunk,
                           handoff_pages=handoff_pages, page_size=page_size)
        hot = predict_slo(cfg, s_p - hit, s_d, t, p, hw=hw, ov=ov,
                          batch=batch, dtype_bytes=dtype_bytes, c=c,
                          inflight=inflight, quant=quant,
                          quant_chunk=quant_chunk,
                          handoff_pages=handoff_pages, page_size=page_size)
        mix = lambda a, b: (1.0 - hit_rate) * a + hit_rate * b
        breakdown = dict(cold.breakdown)
        breakdown.update({"hit_rate": hit_rate, "hit_len": hit,
                          "ttft_cold": cold.ttft, "ttft_hit": hot.ttft})
        return SLOReport(mix(cold.ttft, hot.ttft), cold.tpot,
                         mix(cold.e2e, hot.e2e),
                         mix(cold.comm_volume, hot.comm_volume),
                         breakdown, occupancy=cold.occupancy)
    n_active = cfg.active_param_count()
    world = t * c * p
    nodes = max(1, math.ceil(world / hw.intra_degree))
    # placement puts each TP group on contiguous chips, so TP collectives
    # cross nodes only when t itself outgrows the fast domain; the CP ring
    # wraps the t-groups and crosses once the t·c stage group does
    tp_cross = t > hw.intra_degree
    cp_cross = t * c > hw.intra_degree
    cross_links = max(0, min(p - 1, nodes - 1)) if p > 1 else 0

    # CP ring ops timed separately (they cross at t·c, the rest at t)
    cp_ops = cp_comm_ops(cfg, s_p, c, t=t, b=dtype_bytes, batch=batch)
    qkw = dict(quant=quant, quant_chunk=quant_chunk)
    ops = comm_ops_for(cfg, s_p, s_d, t, p, batch=batch, b=dtype_bytes,
                       **qkw) \
        if c == 1 else comm_ops_for(cfg, cp_shard_len(s_p, c), s_d, t, p,
                                    batch=batch, b=dtype_bytes, **qkw)
    comm_volume = sum(o.wire_bytes for o in ops + cp_ops)

    def phase_comm(phase: str) -> float:
        total = 0.0
        for o in cp_ops:
            if o.phase == phase:
                total += _collective_time(o, hw, cp_cross)
        for o in ops:
            if o.phase != phase:
                continue
            if o.collective in ("send", "recv"):
                if o.collective == "recv":
                    continue
                # split p2p count between intra and cross links (guarded
                # rounding: parts always sum to o.count)
                n_intra, n_cross = split_p2p_count(o.count, p, cross_links)
                intra = dataclasses.replace(o, count=n_intra)
                cross = dataclasses.replace(o, count=n_cross)
                total += _collective_time(intra, hw, False)
                total += _collective_time(cross, hw, True)
            elif (quant is not None and o.dtype_bytes <= 1
                  and o.collective in ("reducescatter", "allgather",
                                       "alltoall")):
                # quantized two-step payload rows (1-byte int8/fp8, or the
                # half-byte int4 alltoall/allgather pair): bytes-only — the
                # α is carried once per quantized AR by the amax-allreduce
                # row (see the quant paragraph in the docstring)
                bw = hw.inter_bw if tp_cross else hw.intra_bw
                total += o.wire_bytes / bw
            else:
                total += _collective_time(o, hw, tp_cross)
        return total

    # disaggregated admission (DESIGN.md §14): KV pages cross from the
    # prefill pool before decode starts — one cross-node α (the transfer
    # is a single batched send) plus the pages' wire bytes
    handoff_s = 0.0
    if handoff_pages:
        handoff_bytes = float(sum(
            o.wire_bytes for o in kv_handoff_ops(cfg, handoff_pages,
                                                 page_size,
                                                 b=dtype_bytes)))
        handoff_s = hw.inter_alpha + handoff_bytes / hw.inter_bw
        comm_volume += handoff_bytes

    eff = _prefill_eff(n_active, ov)
    prefill_flops = 2 * n_active * s_p * batch
    # PP serializes stages: compute parallelism over the t·c stage group
    # (CP shards the prefill sequence — each worker runs s_p/c positions)
    prefill_compute = prefill_flops / (max(t * c, 1) * hw.peak_flops * eff)
    ttft = (ov.request_overhead + prefill_compute + phase_comm("prefill")
            + handoff_s
            + (p * ov.stage_overhead_prefill if p > 1 else 0.0)
            + (2 * cfg.num_layers * (c - 1) * ov.cp_round_overhead
               if c > 1 else 0.0))

    # decode: weight streaming at HBM bandwidth; stages serialized
    param_bytes = n_active * dtype_bytes
    decode_compute = param_bytes / (max(t, 1) * hw.hbm_bw * ov.decode_hbm_eff)
    decode_comm = phase_comm("decode") / max(s_d - 1, 1)
    tpot = (decode_compute + cfg.num_layers * ov.per_layer_launch
            + (p * ov.stage_overhead_decode if p > 1 else 0.0)
            + cross_links * ov.cross_link_decode_overhead + decode_comm)

    # dynamic-schedule occupancy (DESIGN.md §11): depth-d in-flight
    # microbatching fills d of the p bubble slots, so the effective
    # per-request token cadence divides by the filled fraction × depth.
    depth_eff = min(max(1, int(inflight)), p)
    occ = depth_eff / p if p > 1 else 1.0
    tpot_effective = tpot / depth_eff if p > 1 else tpot

    e2e = ttft + max(s_d - 1, 0) * tpot_effective
    breakdown = {
        "prefill_compute": prefill_compute,
        "prefill_comm": phase_comm("prefill"),
        "decode_compute": decode_compute,
        "decode_comm_per_tok": decode_comm,
        "pp_occupancy": occ, "tpot_effective": tpot_effective,
        "nodes": nodes, "tp_cross": tp_cross, "cross_links": cross_links,
    }
    if handoff_pages:
        breakdown["handoff_s"] = handoff_s
        breakdown["handoff_bytes"] = handoff_bytes
    return SLOReport(ttft, tpot, e2e, comm_volume, breakdown, occupancy=occ)


# ---------------------------------------------------------------------------
# goodput under overload (DESIGN.md §10)
# ---------------------------------------------------------------------------


def recompute_time(cfg: ModelConfig, prefix_len: int, t: int = 1, p: int = 1,
                   hw: HardwareProfile = H100_NODE,
                   ov: EngineOverheads = DEFAULT_OVERHEADS,
                   batch: int = 1, dtype_bytes: int = 2,
                   c: int = 1) -> float:
    """Wall time of ONE preemption's recompute pass: the TTFT of a
    ``prefix_len``-token prefill minus the per-request frontend overhead
    (the request is already tokenized and scheduled — recovery re-runs the
    model, not the frontend).  The communication inside is
    ``commodel.preemption_recompute_ops``."""
    rep = predict_slo(cfg, prefix_len, 1, t, p, hw=hw, ov=ov, batch=batch,
                      dtype_bytes=dtype_bytes, c=c)
    return max(0.0, rep.ttft - ov.request_overhead)


@dataclasses.dataclass
class GoodputReport:
    """Predicted serving capacity of one admission policy under a given
    request mix and KV-cache budget."""

    concurrency: int          # requests decoding at once (slot- or page-bound)
    preempt_rate: float       # expected preemptions per request
    recompute_s: float        # wall cost of one recompute pass
    service_s: float          # per-request service time incl. recovery
    goodput_tok_s: float      # useful tokens completed per second
    breakdown: Dict[str, float]

    def row(self) -> str:
        return (f"conc {self.concurrency:3d}  preempt/req "
                f"{self.preempt_rate:5.2f}  service {self.service_s:6.3f} s  "
                f"goodput {self.goodput_tok_s:8.1f} tok/s")


def predict_goodput(cfg: ModelConfig, s_p: int, s_d: int, *,
                    num_slots: int, capacity_tokens: int,
                    eos_mean: float = None, admission: str = "conservative",
                    t: int = 1, p: int = 1,
                    hw: HardwareProfile = H100_NODE,
                    ov: EngineOverheads = DEFAULT_OVERHEADS,
                    dtype_bytes: int = 2, c: int = 1,
                    inflight: int = 1, quant: str = None,
                    quant_chunk: int = DEFAULT_QUANT_CHUNK) -> GoodputReport:
    """Goodput of a slot/page-bound serving engine under overload.

    The request mix decodes ``eos_mean`` tokens on average (early stop;
    defaults to the full budget ``s_d``) but commits ``s_d`` at admission.
    Conservative admission reserves each request's worst case
    (``s_p + s_d - 1`` cache positions), so concurrency is bound by
    ``capacity_tokens // worst`` even though most requests never grow that
    far — the stranded-capacity effect.  Optimistic admission packs by the
    *actual* footprint (``s_p + eos_mean - 1``) and pays for the
    overcommit with preemptions: when the expected live footprint
    ``concurrency × actual`` exceeds capacity, the overflow fraction is
    recovered by recompute passes of the mean preempted prefix
    (``recompute_time``).  Goodput divides useful tokens by the per-request
    service time including that recovery tax — the quantity the overload
    series of benchmarks/serving_bench.py measures."""
    if admission not in ("conservative", "optimistic"):
        raise ValueError(f"unknown admission policy {admission!r}")
    n_eff = float(s_d if eos_mean is None else min(eos_mean, s_d))
    if n_eff < 1:
        raise ValueError(f"eos_mean must be >= 1, got {eos_mean}")
    worst = s_p + s_d - 1
    actual = s_p + n_eff - 1.0
    if admission == "conservative":
        concurrency = min(num_slots, capacity_tokens // worst)
        preempt_rate = 0.0
    else:
        # optimistic admits on CURRENT need (the prompt's pages) — so the
        # admitted set is prompt-bound, its live footprint can overflow
        # capacity, and the overflow is recovered by preemption
        admitted = min(num_slots, int(capacity_tokens // s_p))
        preempt_rate = max(0.0, admitted * actual / capacity_tokens - 1.0)
        # steady-state decoding set is what the actual footprint sustains
        concurrency = min(admitted, int(capacity_tokens // actual))
    concurrency = max(concurrency, 1) if capacity_tokens >= worst else 0
    if concurrency == 0:
        return GoodputReport(0, 0.0, 0.0, float("inf"), 0.0,
                             {"worst_tokens": worst, "actual_tokens": actual})
    base = predict_slo(cfg, s_p, int(round(n_eff)), t, p, hw=hw, ov=ov,
                       batch=concurrency, dtype_bytes=dtype_bytes, c=c,
                       inflight=inflight, quant=quant,
                       quant_chunk=quant_chunk)
    # a preemption strikes mid-decode: mean recomputed prefix is the prompt
    # plus half the decoded tokens
    rec = recompute_time(cfg, int(s_p + n_eff / 2), t, p, hw=hw, ov=ov,
                         dtype_bytes=dtype_bytes, c=c)
    service = (base.ttft
               + max(int(round(n_eff)) - 1, 0)
               * base.breakdown["tpot_effective"]
               + preempt_rate * rec)
    goodput = concurrency * n_eff / service
    return GoodputReport(
        concurrency=int(concurrency), preempt_rate=preempt_rate,
        recompute_s=rec, service_s=service, goodput_tok_s=goodput,
        breakdown={"worst_tokens": float(worst), "actual_tokens": actual,
                   "e2e_s": base.e2e, "recovery_s": preempt_rate * rec,
                   "pp_occupancy": base.occupancy})
