"""Automated parallelism selection (the paper's §VII 'future work', built).

Given a model, a serving scenario (S_p, S_d, SLO weights) and a hardware
profile, enumerate feasible (t, c, p) layouts, score each with the
analytical SLO model, and return a ranked plan.  The ranking reproduces the
paper's §V-C deployment guidance plus the sequence-parallel extension of
the companion work (arXiv:2408.10197):
  * short sequences + intra-node ⇒ pure TP (TTFT-optimal),
  * long-form generation / bandwidth-constrained ⇒ PP (volume-optimal),
  * moderate workloads ⇒ balanced hybrids; avoid unbalanced ones,
  * long prompts whose prefill is compute-bound on one TP group ⇒ context
    parallelism (CP shards the prefill sequence, DESIGN.md §9) — CP wins
    TTFT there and is pure overhead on short prompts.

It is the JAX package's ``repro.core.planner`` with the imports renamed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.config.base import HardwareProfile, H100_NODE, ModelConfig
from repro_torch.core.slo import DEFAULT_OVERHEADS, EngineOverheads, SLOReport, \
    predict_slo


@dataclasses.dataclass
class PlanCandidate:
    tensor_parallel: int
    context_parallel: int
    pipeline_parallel: int
    slo: SLOReport
    score: float
    occupancy: float = 1.0

    @property
    def name(self) -> str:
        return (f"TP={self.tensor_parallel} CP={self.context_parallel} "
                f"PP={self.pipeline_parallel}")


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def feasible_layouts(cfg: ModelConfig, world: int) -> List[tuple]:
    """All (t, c, p) with t·c·p == world the system can actually run.

    Constraints: the attention and kv heads must shard over t, and every
    pipeline stage must own at least one layer — p <= num_layers.  An
    INDIVISIBLE layer count is feasible: ``commodel.stage_layer_partition``
    spreads the remainder over the early stages and the engines follow the
    same split, so the old ``num_layers % p == 0`` filter silently
    excluded layouts the system serves fine (e.g. Llama-3.2-3B's 28 layers
    at p=8).  CP adds no divisibility constraint of its own — prompts pad
    to a multiple of c (DESIGN.md §9).
    """
    outs = []
    for t in _divisors(world):
        if cfg.num_kv_heads % t or cfg.num_heads % t:
            continue
        for c in _divisors(world // t):
            p = world // (t * c)
            if p > cfg.num_layers:
                continue
            outs.append((t, c, p))
    return outs


def plan(cfg: ModelConfig, world: int, s_p: int, s_d: int, *,
         hw: HardwareProfile = H100_NODE,
         ov: EngineOverheads = DEFAULT_OVERHEADS,
         objective: str = "e2e",
         volume_budget: Optional[float] = None,
         inflight: int = 1, quant: Optional[str] = None,
         hit_rate: float = 0.0,
         hit_len: Optional[int] = None) -> List[PlanCandidate]:
    """Rank all feasible (t, c, p) layouts for ``world`` chips.

    objective: "ttft" | "tpot" | "e2e" | "volume".
    volume_budget: optional cap on comm wire bytes (models a bandwidth-
    constrained fabric — layouts above the cap are ranked last).
    inflight: dynamic-schedule microbatch depth (DESIGN.md §11).  PP
    layouts are scored with ``min(inflight, p)/p`` of the decode bubble
    filled — the "tpot" objective ranks by ``tpot_effective``, and "e2e"
    inherits the same term through predict_slo, so a deep pipeline that
    looks bad serialized can win once the scheduler keeps it occupied.
    At inflight=1 the ranking is bitwise the old one.
    quant: "int8" | "fp8" (DESIGN.md §12) scores every layout with the
    decode-phase TP allreduces priced at the quantized two-step — deep-TP
    layouts whose decode wire bytes priced them off the frontier re-enter
    it on short sequences (Flash Communication's shape).
    hit_rate / hit_len: expected prefix-cache hit statistics of the
    traffic (DESIGN.md §13).  Every layout is scored with ``hit_rate`` of
    requests prefilling only their ``s_p - hit_len`` suffix, so under
    template-heavy traffic prefill-bound advantages (CP's sharded
    prefill in particular) shrink toward zero and decode-bound layouts
    climb the ranking; at hit_rate=0 the ranking is bitwise the old one.
    """
    cands = []
    for t, c, p in feasible_layouts(cfg, world):
        slo = predict_slo(cfg, s_p, s_d, t, p, hw=hw, ov=ov, c=c,
                          inflight=inflight, quant=quant,
                          hit_rate=hit_rate, hit_len=hit_len)
        score = {
            "ttft": slo.ttft, "tpot": slo.breakdown["tpot_effective"],
            "e2e": slo.e2e, "volume": slo.comm_volume,
        }[objective]
        if volume_budget is not None and slo.comm_volume > volume_budget:
            score = float("inf")
        cands.append(PlanCandidate(t, c, p, slo, score,
                                   occupancy=slo.occupancy))
    cands.sort(key=lambda x: (x.score, x.slo.e2e))
    return cands


def recommend(cfg: ModelConfig, world: int, s_p: int, s_d: int,
              **kw) -> PlanCandidate:
    return plan(cfg, world, s_p, s_d, **kw)[0]


# ---------------------------------------------------------------------------
# disaggregated prefill/decode planning (DESIGN.md §14)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One request class of a mixed trace: arrival rate (req/s) at a fixed
    prompt/decode shape.  A workload is a list of these — e.g. chat
    (short s_p, long s_d) plus summarization (long s_p, short s_d)."""

    name: str
    s_p: int
    s_d: int
    rate: float

    def __post_init__(self):
        if self.s_p < 1 or self.s_d < 1:
            raise ValueError(
                f"class {self.name!r}: s_p and s_d must be >= 1")
        if self.rate <= 0:
            raise ValueError(
                f"class {self.name!r}: rate must be > 0, got {self.rate}")


@dataclasses.dataclass
class DisaggCandidate:
    """One serving-plane candidate for a mixed workload: either every
    class colocated on one engine pool, or a prefill pool + decode pool
    split (DESIGN.md §14).  ``utilization`` is the prefill busy fraction
    of the DECODE-serving engine — the head-of-line interference term
    that inflates its TPOT by 1/(1-u)."""

    mode: str                          # "colocated" | "disagg"
    decode_layout: tuple               # (t, c, p) of the decode-serving pool
    prefill_layout: Optional[tuple]    # (t, c, p); None when colocated
    prefill_world: int                 # chips on the prefill pool (0 = colo)
    score: float
    utilization: float
    per_class: dict                    # name -> {ttft, tpot, e2e, volume}

    @property
    def name(self) -> str:
        t, c, p = self.decode_layout
        dec = f"TP={t} CP={c} PP={p}"
        if self.mode == "colocated":
            return f"colocated[{dec}]"
        tt, cc, pp = self.prefill_layout
        return (f"disagg[pre({self.prefill_world}): TP={tt} CP={cc} "
                f"PP={pp} | dec: {dec}]")


def _busy(rep, ov) -> float:
    """Engine-busy seconds one request's prefill costs the pool that runs
    it (the front-end overhead is off-engine — same split as
    ``slo.recompute_time``)."""
    return max(0.0, rep.ttft - ov.request_overhead)


def _aggregate(per_class: dict, classes, objective: str) -> float:
    rate_tot = sum(k.rate for k in classes)
    return sum(k.rate / rate_tot * per_class[k.name][objective]
               for k in classes)


def plan_disagg(cfg: ModelConfig, world: int, classes, *,
                hw: HardwareProfile = H100_NODE,
                ov: EngineOverheads = DEFAULT_OVERHEADS,
                objective: str = "e2e", page_size: int = 16,
                route_prompt_len: Optional[int] = None,
                inflight: int = 1,
                quant: Optional[str] = None) -> List[DisaggCandidate]:
    """Rank colocated vs disaggregated serving planes for a mixed workload
    (DESIGN.md §14).

    The interference model is processor sharing: on an engine that serves
    both phases, prefill passes steal ``u = Σ rate·prefill_busy`` of the
    wall clock from decode rounds, so every class's effective TPOT is the
    clean TPOT × 1/(1-u) (u ≥ 1 is overload: score = inf).  That is the
    head-of-line cost the paper's mixed traces measure and disaggregation
    kills: the decode pool's u keeps only the SHORT classes' prefills plus
    the long classes' ≤ page_size suffix chunks — the long prefills move
    to the prefill pool, whose own utilization must also stay < 1 — at
    the price of (a) fewer chips serving decode and (b) a per-request
    handoff term (``predict_slo(handoff_pages=...)``) on long TTFT.  Hence
    the decision rule the ranking reproduces: prefill-heavy mixes prefer
    disagg, short-chat-only traffic keeps colocated (splitting the world
    just removes decode chips and idles a prefill pool).

    The decode pool is restricted to c == 1 layouts — handed-off requests
    admit through the prefix index, whose suffix prefill needs the
    chunk-offset path (DESIGN.md §13).  Long classes route to the prefill
    pool when ``s_p >= route_prompt_len`` (default 2 × page_size), the
    same routing rule ``runtime.scheduler.DisaggScheduler`` applies.
    """
    classes = list(classes)
    if not classes:
        raise ValueError("plan_disagg needs at least one TrafficClass")
    if objective not in ("ttft", "tpot", "e2e", "volume"):
        raise ValueError(f"unknown objective {objective!r}")
    thresh = 2 * page_size if route_prompt_len is None \
        else int(route_prompt_len)
    longs = [k for k in classes if k.s_p >= thresh]
    shorts = [k for k in classes if k.s_p < thresh]
    kw = dict(hw=hw, ov=ov, inflight=inflight, quant=quant)
    cands: List[DisaggCandidate] = []

    def row(rep, k, inflate: float) -> dict:
        tpot = rep.breakdown["tpot_effective"] * inflate
        return {"ttft": rep.ttft, "tpot": tpot,
                "e2e": rep.ttft + max(k.s_d - 1, 0) * tpot,
                "volume": rep.comm_volume}

    # -- colocated: one pool serves both phases of every class
    for t, c, p in feasible_layouts(cfg, world):
        reps = {k.name: predict_slo(cfg, k.s_p, k.s_d, t, p, c=c, **kw)
                for k in classes}
        u = sum(k.rate * _busy(reps[k.name], ov) for k in classes)
        inflate = 1.0 / (1.0 - u) if u < 1.0 else float("inf")
        per = {k.name: row(reps[k.name], k, inflate) for k in classes}
        cands.append(DisaggCandidate(
            "colocated", (t, c, p), None, 0,
            _aggregate(per, classes, objective), u, per))

    # -- disagg: every (prefill chips, decode chips) split of the world
    for w_pre in range(1, world) if longs else ():
        w_dec = world - w_pre
        dec_layouts = [(t, c, p) for t, c, p in feasible_layouts(cfg, w_dec)
                       if c == 1]
        pre_layouts = feasible_layouts(cfg, w_pre)
        for dt, dc, dp in dec_layouts:
            # decode-pool view of each class: shorts serve whole; longs
            # arrive with their full blocks handed off and prefill only
            # the suffix the §13 lookup leaves (1..page_size positions)
            reps = {}
            for k in shorts:
                reps[k.name] = predict_slo(cfg, k.s_p, k.s_d, dt, dp,
                                           c=dc, **kw)
            for k in longs:
                pages = k.s_p // page_size
                suffix = k.s_p - min(k.s_p - 1, pages * page_size)
                reps[k.name] = predict_slo(cfg, suffix, k.s_d, dt, dp,
                                           c=dc, handoff_pages=pages,
                                           page_size=page_size, **kw)
            u_dec = sum(k.rate * _busy(reps[k.name], ov) for k in classes)
            if u_dec >= 1.0:
                continue
            inflate = 1.0 / (1.0 - u_dec)
            for pt, pc, pp in pre_layouts:
                pre = {k.name: predict_slo(cfg, k.s_p, 2, pt, pp, c=pc,
                                           **kw) for k in longs}
                u_pre = sum(k.rate * _busy(pre[k.name], ov) for k in longs)
                if u_pre >= 1.0:
                    continue
                per = {}
                for k in classes:
                    r = row(reps[k.name], k, inflate)
                    if k.name in pre:
                        # a long request's TTFT chains the pools: its
                        # prefill runs on the prefill pool, then the
                        # handoff + suffix admission on the decode pool
                        # (already inside r via handoff_pages)
                        extra = _busy(pre[k.name], ov)
                        r["ttft"] += extra
                        r["e2e"] += extra
                        r["volume"] += pre[k.name].comm_volume
                    per[k.name] = r
                cands.append(DisaggCandidate(
                    "disagg", (dt, dc, dp), (pt, pc, pp), w_pre,
                    _aggregate(per, classes, objective),
                    max(u_dec, u_pre), per))

    cands.sort(key=lambda x: (x.score,
                              _aggregate(x.per_class, classes, "e2e")))
    return cands


def recommend_disagg(cfg: ModelConfig, world: int, classes,
                     **kw) -> DisaggCandidate:
    return plan_disagg(cfg, world, classes, **kw)[0]
