"""Analytical communication models — the paper's Section III, executable.

Every model returns a list of :class:`CommOp` (collective type, phase, call
count, per-call message shape, worker count).  Summing wire bytes with the
paper's NCCL ring correction factors reproduces Eq. 1 (TP), Eq. 2 (PP) and
Eq. 3–7 (hybrid) exactly; the per-op breakdown reproduces the count/shape
columns of Tables III–VI.

Accounting conventions (paper Section V):
  * allreduce wire volume:  2(d-1)/d × message bytes     [ring allreduce]
  * allgather wire volume:   (d-1)/d × gathered bytes
  * gather / p2p:            1 × message bytes
  * "send" and "recv" are both reported (the paper's profiler counts each
    direction, Table V) but only sends are charged in volume (Eq. 2).
  * per-link p2p carries TWO tensors per hop (hidden states + residual —
    the paper's "KV factor", Table V pattern (p-1)·2·…).

Beyond-paper extensions (flagged, OFF for paper-parity):
  * batch > 1 serving (the paper is single-request),
  * MoE expert-parallel all-to-all (paper §VII future work),
  * SSM/RWKV state hand-off between pipeline stages,
  * gather_mode="allgather" — XLA has no gather-to-root collective, so the
    TPU engine all-gathers the vocab shards instead (DESIGN.md §2),
  * context parallelism (``cp_comm_ops``, ``comm_ops_for(c=...)``) — the
    sequence axis sharded over a third mesh axis during *prefill only*
    (DESIGN.md §9): per layer the c workers of a CP group ring-exchange
    their K/V blocks in (c-1) collective-permute rounds of TWO tensors
    each (K and V — the companion paper arXiv:2408.10197's sequence-
    parallel exchange pattern), plus one [B, h] allreduce over the CP
    group to hand the last position's hidden state to the logits head.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from repro_torch.config.base import ModelConfig

_WIRE_FACTOR = {
    "allreduce": lambda d: 2.0 * (d - 1) / d,
    "allgather": lambda d: (d - 1) / d,
    "reducescatter": lambda d: (d - 1) / d,
    "gather": lambda d: 1.0,
    "alltoall": lambda d: (d - 1) / d,
    "send": lambda d: 1.0,
    "recv": lambda d: 0.0,   # same bytes as the matching send (not double-charged)
    "collectivepermute": lambda d: 1.0,   # ring hop: every rank ships its block
}

# Quantized-collective width entries (DESIGN.md §12): the two-step decode
# allreduce ships its payload at one of these widths while the per-chunk
# scales travel as f32.  fp8 is modeled at its nominal 1-byte width — real
# accelerator wire bytes; host-CPU XLA upcasts the f8 payload to f16 on the
# wire, which the HLO-parity tests gate per-platform.  int4 ships two
# values per uint8 byte (``kernels.quant_collective.chunk_quantize_pack``),
# hence the half-byte wire width.
QUANT_WIRE_BYTES = {"int8": 1, "fp8": 1, "int4": 0.5}
QUANT_SCALE_BYTES = 4
DEFAULT_QUANT_CHUNK = 128


@dataclasses.dataclass(frozen=True)
class CommOp:
    """One homogeneous class of collective calls."""

    collective: str              # allreduce|allgather|gather|send|recv|alltoall
    phase: str                   # "prefill" | "decode"
    count: int                   # number of calls
    shape: Tuple[int, ...]       # per-call message shape (elements)
    workers: int                 # participating workers d
    dtype_bytes: int = 2         # FP16/BF16 throughout the paper

    @property
    def elements(self) -> int:
        return math.prod(self.shape)

    @property
    def msg_bytes(self) -> int:
        """Raw bytes of one message (the paper's 'Message Size' column)."""
        return self.elements * self.dtype_bytes

    @property
    def total_msg_bytes(self) -> int:
        return self.count * self.msg_bytes

    @property
    def wire_bytes(self) -> float:
        """Network volume with the paper's correction factor applied."""
        return self.total_msg_bytes * _WIRE_FACTOR[self.collective](self.workers)


def total_volume(ops: List[CommOp], phase: Optional[str] = None) -> float:
    return sum(o.wire_bytes for o in ops if phase in (None, o.phase))


def by_collective(ops: List[CommOp]):
    out = {}
    for o in ops:
        out.setdefault(o.collective, []).append(o)
    return out


# ---------------------------------------------------------------------------
# Quantized two-step collectives (Flash Communication, DESIGN.md §12)
# ---------------------------------------------------------------------------


def quant_chunks(h: int, chunk: int) -> int:
    """Scale blocks covering a hidden width: ceil(h / chunk) — the last
    block may cover a remainder shorter than ``chunk``."""
    if chunk < 1:
        raise ValueError(f"quant chunk must be >= 1, got {chunk}")
    return -(-h // chunk)


def quant_decode_ar_ops(phase: str, count: int, rows: int, h: int, t: int,
                        quant: str, chunk: int) -> List[CommOp]:
    """Decompose ``count`` bf16 [rows, h] decode allreduces into the
    quantized two-step's wire ops (``parallel_exec.quantized_psum``):

      1. one f32 [rows, K] allreduce — the per-chunk abs-max exchange
         (``lax.pmax``) that gives every rank the shared scales,
      2. one 1-byte [rows, h] reducescatter — the quantized partial sums,
         exact integer addition under the floor(qmax/t) headroom,
      3. one 1-byte [rows, h] allgather — redistributing the reduced shards.

    ``quant="int4"`` swaps the reducescatter for a half-byte [rows, h]
    alltoall: packed nibbles cannot be partially summed on the wire, so
    each rank instead receives every rank's packed copy of its own hidden
    block, reduces exactly in int32, and the re-packed halves ride the
    half-byte allgather — same two payload hops, both at 0.5 bytes/element
    (``parallel_exec.quantized_psum``, DESIGN.md §12).

    Counts stay batch-invariant (``rows`` scales message bytes only) and the
    closed-form wire ratio vs one b-byte allreduce is
    ``(payload·2h + scale·2·4K) / (2·2h)`` — see ``quant_ar_wire_ratio``.
    """
    if quant not in QUANT_WIRE_BYTES:
        raise ValueError(f"unknown quant mode {quant!r}; "
                         f"expected one of {sorted(QUANT_WIRE_BYTES)}")
    K = quant_chunks(h, chunk)
    w = QUANT_WIRE_BYTES[quant]
    payload = "alltoall" if quant == "int4" else "reducescatter"
    return [
        CommOp("allreduce", phase, count, (rows, K), t, QUANT_SCALE_BYTES),
        CommOp(payload, phase, count, (rows, h), t, w),
        CommOp("allgather", phase, count, (rows, h), t, w),
    ]


def quant_ar_wire_ratio(h: int, t: int, quant: str = "int8",
                        chunk: int = DEFAULT_QUANT_CHUNK,
                        b: int = 2) -> float:
    """Wire bytes of one quantized two-step allreduce over one b-byte ring
    allreduce of the same [rows, h] message, in closed form:

        ratio = (2·w·h + 2·4·K) / (2·b·h)  =  w/b + 4K/(b·h)

    (every term carries the same (t-1)/t ring factor, so the ratio is
    t-invariant: the 1-byte two-step pins the payload at exactly half a
    bf16 ring allreduce plus the f32 scale overhead 4K/h — DESIGN.md §12
    derives why pushing toward ~0.28× needs a 4-bit payload.)"""
    K = quant_chunks(h, chunk)
    w = QUANT_WIRE_BYTES[quant]
    return (2 * w * h + 2 * QUANT_SCALE_BYTES * K) / (2 * b * h)


def _decode_ar_rows(n_layer_ar: int, steps: int, rows: int, h: int, t: int,
                    b: int, quant: Optional[str],
                    chunk: int) -> List[CommOp]:
    """Decode-phase allreduce rows for ``steps`` decode steps, each carrying
    ``n_layer_ar`` per-layer psums + 1 embedding psum of [rows, h].

    Unquantized this is the single aggregate ``(n_layer_ar+1)·steps`` row
    of the paper's Tables; with ``quant`` set the per-layer psums decompose
    into the two-step (``quant_decode_ar_ops``) while the embedding psum —
    which ``parallel_exec`` keeps full-width (its integer-lookup output is
    sparse and cheap; quantizing it buys < 1/(2L) of the bytes) — stays a
    b-byte allreduce."""
    if quant is None:
        return [CommOp("allreduce", "decode", (n_layer_ar + 1) * steps,
                       (rows, h), t, b)]
    return [CommOp("allreduce", "decode", steps, (rows, h), t, b)] + \
        quant_decode_ar_ops("decode", n_layer_ar * steps, rows, h, t,
                            quant, chunk)


# ---------------------------------------------------------------------------
# Eq. 1 — Tensor parallelism
# ---------------------------------------------------------------------------


def tp_comm_ops(cfg: ModelConfig, s_p: int, s_d: int, t: int, *,
                b: int = 2, batch: int = 1,
                gather_mode: str = "gather",
                quant: Optional[str] = None,
                quant_chunk: int = DEFAULT_QUANT_CHUNK) -> List[CommOp]:
    """Pure TP: (2L+1) allreduce per forward pass + per-token logit gather.

    The 2L comes from the two row-parallel linears per layer (attention output
    projection + MLP down-projection); the +1 from the vocab-parallel
    embedding.  Message rows scale with the tokens processed per pass.

    ``quant`` ("int8" | "fp8", DESIGN.md §12) decomposes the *decode-phase
    per-layer* allreduces into the quantized two-step
    (``quant_decode_ar_ops``); prefill rows, the embedding psum and the
    logit gather stay full-width — decode is where the TP wire bytes
    dominate, which is the regime the paper measures and Flash
    Communication attacks.
    """
    if t <= 1:
        return []
    L, h, v = cfg.num_layers, cfg.d_model, cfg.vocab_size
    n_ar = 2 * L + 1
    ops = [
        CommOp("allreduce", "prefill", n_ar, (batch * s_p, h), t, b),
        CommOp("gather", "prefill", 1, (batch * (v // t),), t, b),
    ]
    if s_d > 1:
        ops += _decode_ar_rows(2 * L, s_d - 1, batch * 1, h, t, b,
                               quant, quant_chunk)
        ops += [
            CommOp("gather", "decode", s_d - 1, (batch * (v // t),), t, b),
        ]
    if gather_mode == "allgather":
        ops = [dataclasses.replace(
                   o, collective="allgather",
                   shape=tuple(list(o.shape[:-1]) + [o.shape[-1] * t]))
               if o.collective == "gather" else o for o in ops]
    return ops


def v_tp(cfg: ModelConfig, s_p: int, s_d: int, t: int, b: int = 2) -> float:
    """Eq. 1 in closed form (bytes)."""
    L, h, v = cfg.num_layers, cfg.d_model, cfg.vocab_size
    return ((2 * L + 1) * (s_p + s_d - 1) * h * b * 2 * (t - 1) / t
            + s_d * (v / t) * b)


# ---------------------------------------------------------------------------
# Eq. 2 — Pipeline parallelism
# ---------------------------------------------------------------------------


def pp_comm_ops(cfg: ModelConfig, s_p: int, s_d: int, p: int, *,
                b: int = 2, batch: int = 1, h_shard: int = 1) -> List[CommOp]:
    """Pure PP: 2 tensors per link per pass (hidden states + residual)."""
    if p <= 1:
        return []
    h = cfg.d_model // h_shard
    links = p - 1
    ops = []
    for direction in ("send", "recv"):
        ops.append(CommOp(direction, "prefill", links * 2,
                          (batch * s_p, h), p, b))
        if s_d > 1:
            ops.append(CommOp(direction, "decode", links * 2 * (s_d - 1),
                              (batch * 1, h), p, b))
    return ops


def v_pp(cfg: ModelConfig, s_p: int, s_d: int, p: int, b: int = 2) -> float:
    """Eq. 2 in closed form (bytes)."""
    return (p - 1) * 2 * (s_p + s_d - 1) * cfg.d_model * b


# ---------------------------------------------------------------------------
# Eq. 3–7 — Hybrid TP × PP
# ---------------------------------------------------------------------------


def stage_layer_partition(L: int, p: int) -> List[int]:
    """Layers owned by each pipeline stage; the remainder of an indivisible
    L goes to the *early* stages (stage 0 first), so every layer is always
    assigned.  Shared with ``parallel_exec.stage_layer_range`` — the engine
    and the analytical model must agree on the split."""
    base, rem = divmod(L, p)
    return [base + (1 if s < rem else 0) for s in range(p)]


def hybrid_stage_collectives(cfg: ModelConfig, t: int, p: int,
                             stage: int, c: int = 1,
                             phase: str = "decode",
                             quant: Optional[str] = None) -> dict:
    """Collective *counts per pass* visible in one stage's compiled module
    under the explicit hybrid engine (gather_mode="allgather"): 2·L_s
    allreduces per stage (+1 embedding psum on stage 0), 2 boundary
    redistribute all-gathers on every receiving stage, and the logits
    all-gather on the last stage.  TP counts are identical for a prefill
    pass and a decode pass (only message shapes differ).

    With context parallelism (``c > 1``) a *prefill* pass additionally
    shows the stage's CP ring: 2·L_s·(c-1) collective-permutes (K and V
    rotate around the stage's cp axis each of the c-1 rounds) plus, on the
    last stage, the one allreduce that hands the final position's hidden
    state to the head.  CP is prefill-only — decode passes run replicated
    over the cp axis, so ``phase="decode"`` counts carry no CP term at any
    c (DESIGN.md §9).

    ``quant`` (DESIGN.md §12) applies to *decode* passes only: the stage's
    2·L_s per-layer psums each become one amax allreduce + one quantized
    reducescatter + one allgather, so the stage module shows 2·L_s
    allreduces still (now tiny f32 scale exchanges) plus 2·L_s of each
    two-step half next to the boundary/logit all-gathers; the stage-0
    embedding psum stays full-width.  int4 replaces the reducescatter
    half with the packed-nibble alltoall (``quant_decode_ar_ops``)."""
    L_s = stage_layer_partition(cfg.num_layers, p)[stage]
    counts: dict = {}
    if t > 1:
        counts["allreduce"] = 2 * L_s + (1 if stage == 0 else 0)
        ag = (2 if stage > 0 else 0) + (1 if stage == p - 1 else 0)
        if ag:
            counts["allgather"] = ag
        if quant is not None and phase == "decode":
            if quant == "int4":
                counts["alltoall"] = 2 * L_s
            else:
                counts["reducescatter"] = 2 * L_s
            counts["allgather"] = counts.get("allgather", 0) + 2 * L_s
    if c > 1 and phase == "prefill":
        counts["collectivepermute"] = 2 * L_s * (c - 1)
        if stage == p - 1:
            counts["allreduce"] = counts.get("allreduce", 0) + 1
    return counts


def hybrid_comm_ops(cfg: ModelConfig, s_p: int, s_d: int, t: int, p: int, *,
                    b: int = 2, batch: int = 1,
                    gather_mode: str = "gather",
                    quant: Optional[str] = None,
                    quant_chunk: int = DEFAULT_QUANT_CHUNK) -> List[CommOp]:
    """Hybrid: per-stage allreduce + inter-stage allgather + p2p + gather.

    ``quant`` decomposes the decode-phase per-layer allreduces exactly as
    in ``tp_comm_ops`` (stage-0 rank view: 2·L_0 per-layer psums quantize,
    the embedding psum stays full-width); boundary all-gathers and p2p
    hops are untouched — they already ship 1/t-width shards."""
    if p <= 1:
        return tp_comm_ops(cfg, s_p, s_d, t, b=b, batch=batch,
                           gather_mode=gather_mode, quant=quant,
                           quant_chunk=quant_chunk)
    if t <= 1:
        return pp_comm_ops(cfg, s_p, s_d, p, b=b, batch=batch)
    L, h, v = cfg.num_layers, cfg.d_model, cfg.vocab_size
    # stage-0 rank view: it owns the most layers under the uneven split and
    # carries the embedding allreduce (equals 2L/p + 1 when p divides L)
    n_layer_ar = 2 * stage_layer_partition(L, p)[0]
    n_ar = n_layer_ar + 1
    ops = [
        CommOp("allreduce", "prefill", n_ar, (batch * s_p, h), t, b),
        CommOp("allgather", "prefill", 2 * (p - 1), (batch * s_p, h), t, b),
        CommOp("gather", "prefill", 1, (batch * (v // t),), t, b),
        CommOp("send", "prefill", (p - 1) * 2, (batch * s_p, h // t), p, b),
        CommOp("recv", "prefill", (p - 1) * 2, (batch * s_p, h // t), p, b),
    ]
    if s_d > 1:
        d = s_d - 1
        ops += _decode_ar_rows(n_layer_ar, d, batch * 1, h, t, b,
                               quant, quant_chunk)
        ops += [
            CommOp("allgather", "decode", 2 * (p - 1) * d, (batch * 1, h), t, b),
            CommOp("gather", "decode", d, (batch * (v // t),), t, b),
            CommOp("send", "decode", (p - 1) * 2 * d, (batch * 1, h // t), p, b),
            CommOp("recv", "decode", (p - 1) * 2 * d, (batch * 1, h // t), p, b),
        ]
    if gather_mode == "allgather":
        ops = [dataclasses.replace(
                   o, collective="allgather",
                   shape=tuple(list(o.shape[:-1]) + [o.shape[-1] * t]))
               if o.collective == "gather" else o for o in ops]
    return ops


def v_hybrid_components(cfg: ModelConfig, s_p: int, s_d: int, t: int, p: int,
                        b: int = 2, include_embedding: bool = True) -> dict:
    """Eq. 4–7 in closed form (bytes per component).

    The allreduce term uses the stage-0 layer count of the uneven split
    (== the paper's 2L/p whenever p divides L), keeping the closed form
    equal to the ``hybrid_comm_ops`` per-op sum for every L."""
    L, h, v = cfg.num_layers, cfg.d_model, cfg.vocab_size
    steps = s_p + s_d - 1
    v_ar = (2 * stage_layer_partition(L, p)[0]) * steps * h * b * 2 * (t - 1) / t
    if include_embedding:
        v_ar += steps * h * b * 2 * (t - 1) / t   # first-rank embedding term
    return {
        "allreduce": v_ar,
        "allgather": 2 * (p - 1) * steps * h * b * (t - 1) / t,
        "gather": s_d * (v / t) * b,
        "p2p": (p - 1) * 2 * steps * (h / t) * b,
    }


def v_hybrid(cfg: ModelConfig, s_p: int, s_d: int, t: int, p: int,
             b: int = 2) -> float:
    """Eq. 3 in closed form (bytes)."""
    return sum(v_hybrid_components(cfg, s_p, s_d, t, p, b).values())


def chunked_prefill_ops(cfg: ModelConfig, s_p: int, chunk: int,
                        t: int = 1, p: int = 1, *, b: int = 2,
                        batch: int = 1,
                        gather_mode: str = "gather") -> List[CommOp]:
    """Prefill communication when the prompt is split into fixed-size chunks
    (DESIGN.md §8): ``ceil(s_p / chunk)`` passes, each carrying the SAME
    collective schedule as a full prefill pass — (2L+1) allreduce + 1 logit
    gather under TP, (p-1)·2 boundary sends under PP, the per-stage mix
    under hybrid — with message rows scaled to the chunk's tokens (the final
    chunk may be shorter).  Counts therefore grow linearly with the number
    of chunks while staying batch- and chunk-length-invariant *per chunk*,
    which is what lets the scheduler interleave chunks with decode steps
    without changing any per-step count column.

    The chunked engines compute the logits head every chunk (one uniform
    jitted pass — only the final chunk's argmax is consumed), so the gather
    count is per-chunk too; total allreduce bytes equal the monolithic
    prefill's exactly, the gather bytes exceed it by (n_chunks - 1) calls.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    sizes = [chunk] * (s_p // chunk)
    if s_p % chunk:
        sizes.append(s_p % chunk)
    ops: List[CommOp] = []
    for c in sorted(set(sizes), reverse=True):
        n = sizes.count(c)
        per_pass = hybrid_comm_ops(cfg, c, 1, t, p, b=b, batch=batch,
                                   gather_mode=gather_mode)
        ops += [dataclasses.replace(o, count=o.count * n)
                for o in per_pass if o.phase == "prefill"]
    return ops


# ---------------------------------------------------------------------------
# Context parallelism — sequence-sharded prefill (DESIGN.md §9)
# ---------------------------------------------------------------------------


def cp_shard_len(s_p: int, c: int) -> int:
    """Per-worker sequence shard of a CP prefill: the engines pad the prompt
    to a multiple of c, so every shard carries ``ceil(s_p / c)`` positions."""
    return -(-s_p // c)


def cp_comm_ops(cfg: ModelConfig, s_p: int, c: int, *, t: int = 1,
                b: int = 2, batch: int = 1) -> List[CommOp]:
    """Context-parallel prefill: per layer a ring exchange of the K/V blocks
    over the c sequence shards, aggregated over all pipeline stages (the
    same convention as the hybrid p2p rows).

    Each of the c-1 ring rounds moves TWO tensors (K and V) of one shard's
    [batch · s_p/c, kv_heads/t · head_dim] block per worker — kv heads stay
    TP-sharded, so CP composes with TP without touching its collectives —
    for 2·L·(c-1) collective-permutes per pass.  One extra [batch, h]
    allreduce over the CP group hands the last position's hidden state to
    the logits head (the position lives on one shard; the head runs
    replicated).  CP is prefill-only: decode runs replicated over the cp
    axis and contributes no decode-phase ops here (DESIGN.md §9).
    """
    if c <= 1:
        return []
    L, h = cfg.num_layers, cfg.d_model
    shard = cp_shard_len(s_p, c)
    kv_elems = (cfg.num_kv_heads // t) * cfg.head_dim
    return [
        CommOp("collectivepermute", "prefill", 2 * L * (c - 1),
               (batch * shard, kv_elems), c, b),
        CommOp("allreduce", "prefill", 1, (batch, h), c, b),
    ]


def v_cp(cfg: ModelConfig, s_p: int, c: int, t: int = 1, b: int = 2) -> float:
    """CP ring volume in closed form (bytes): 2L(c-1) blocks of
    ceil(s_p/c)·kv/t·D plus the last-hidden allreduce."""
    return total_volume(cp_comm_ops(cfg, s_p, c, t=t, b=b))


# ---------------------------------------------------------------------------
# Beyond-paper extensions
# ---------------------------------------------------------------------------


def moe_comm_ops(cfg: ModelConfig, s_p: int, s_d: int, e: int, *,
                 b: int = 2, batch: int = 1) -> List[CommOp]:
    """Expert-parallel all-to-all (paper §VII future work).

    Per MoE layer and forward pass: one dispatch and one combine all-to-all;
    each token is replicated to its top_k experts, so the message carries
    tokens × top_k rows of h.
    """
    if cfg.moe is None or e <= 1:
        return []
    L, h, k = cfg.num_layers, cfg.d_model, cfg.moe.top_k
    ops = [CommOp("alltoall", "prefill", 2 * L, (batch * s_p * k, h), e, b)]
    if s_d > 1:
        ops.append(CommOp("alltoall", "decode", 2 * L * (s_d - 1),
                          (batch * k, h), e, b))
    return ops


def ssm_pp_state_ops(cfg: ModelConfig, s_d: int, p: int, *, b: int = 2,
                     batch: int = 1) -> List[CommOp]:
    """RWKV/SSM pipeline hand-off: the recurrent state never moves (it is
    layer-local), so PP transfers are identical to dense PP — except that an
    engine migrating a request between stage replicas must ship the state:
    [H, hs, hs] per layer.  Exposed for capacity planning; zero by default in
    steady-state serving."""
    if cfg.ssm is None or p <= 1:
        return []
    H, hs = cfg.num_heads, cfg.ssm.head_size
    per_stage_layers = stage_layer_partition(cfg.num_layers, p)[0]
    return [CommOp("send", "decode", 1,
                   (batch * per_stage_layers * H, hs, hs), p, 4)]


def comm_ops_for(cfg: ModelConfig, s_p: int, s_d: int, t: int = 1, p: int = 1,
                 e: int = 1, *, c: int = 1, b: int = 2, batch: int = 1,
                 gather_mode: str = "gather", quant: Optional[str] = None,
                 quant_chunk: int = DEFAULT_QUANT_CHUNK) -> List[CommOp]:
    """Full per-architecture comm prediction: paper terms + extensions.

    Encoder-only architectures have no decode phase (s_d forced to 1); MoE
    architectures add expert-parallel all-to-all when e > 1.  Context
    parallelism (``c > 1``, DESIGN.md §9) shards the *prefill* sequence
    axis: the TP/PP prefill rows shrink to the ceil(s_p/c) shard each rank
    actually processes, the CP ring rows (``cp_comm_ops``) are added, and
    decode rows are untouched — decode runs replicated over the cp axis.
    ``quant`` ("int8" | "fp8", DESIGN.md §12) decomposes the decode-phase
    per-layer TP allreduces into the quantized two-step with ``quant_chunk``
    elements per f32 scale block.
    """
    if not cfg.is_decoder:
        s_d = 1
    s_eff = cp_shard_len(s_p, c) if c > 1 else s_p
    ops = hybrid_comm_ops(cfg, s_eff, s_d, t, p, b=b, batch=batch,
                          gather_mode=gather_mode, quant=quant,
                          quant_chunk=quant_chunk)
    ops += cp_comm_ops(cfg, s_p, c, t=t, b=b, batch=batch)
    ops += moe_comm_ops(cfg, s_eff, s_d, e, b=b, batch=batch)
    return ops


def preemption_recompute_ops(cfg: ModelConfig, prefix_len: int, t: int = 1,
                             p: int = 1, *, c: int = 1, b: int = 2,
                             batch: int = 1,
                             gather_mode: str = "gather") -> List[CommOp]:
    """Collectives of ONE preemption's recompute pass (DESIGN.md §10).

    Preemption-by-recompute re-admits an evicted request by re-prefilling
    its prompt + generated prefix (``prefix_len`` positions) in one
    monolithic pass — so the recovery cost is exactly a prefill's
    communication, with no decode rows: the prefill-phase rows of
    ``comm_ops_for`` at ``s_p = prefix_len``.  The scheduler logs these
    counts on each phase="recompute" StepRecord, extending the house
    invariant (predicted == compiled == measured) to the failure path.
    """
    ops = comm_ops_for(cfg, prefix_len, 1, t, p, c=c, b=b, batch=batch,
                       gather_mode=gather_mode)
    return [o for o in ops if o.phase == "prefill"]


# ---------------------------------------------------------------------------
# Cross-request prefix caching — skipped vs executed prefill (DESIGN.md §13)
# ---------------------------------------------------------------------------


def _agg_counts(ops: List[CommOp]) -> dict:
    counts: dict = {}
    for o in ops:
        counts[o.collective] = counts.get(o.collective, 0) + o.count
    return counts


@dataclasses.dataclass(frozen=True)
class PrefixCacheOps:
    """Executed-vs-skipped prefill communication of ONE cache-hit request
    (DESIGN.md §13): ``executed`` is what the suffix prefill actually
    issues — the rows the compiled HLO and the scheduler's phase="prefill"
    StepRecords must match — and ``cold`` is what the same request would
    have issued with no hit; the *savings* are their difference."""

    hit_len: int
    suffix_len: int
    executed: List[CommOp]
    cold: List[CommOp]

    @property
    def executed_counts(self) -> dict:
        return _agg_counts(self.executed)

    @property
    def cold_counts(self) -> dict:
        return _agg_counts(self.cold)

    @property
    def skipped_counts(self) -> dict:
        ex = self.executed_counts
        return {k: v - ex.get(k, 0) for k, v in self.cold_counts.items()}

    @property
    def executed_bytes(self) -> float:
        return sum(o.wire_bytes for o in self.executed)

    @property
    def cold_bytes(self) -> float:
        return sum(o.wire_bytes for o in self.cold)

    @property
    def skipped_bytes(self) -> float:
        return self.cold_bytes - self.executed_bytes


def prefix_cache_ops(cfg: ModelConfig, hit_len: int, suffix_len: int,
                     chunk: Optional[int] = None, t: int = 1, p: int = 1,
                     *, b: int = 2, batch: int = 1,
                     gather_mode: str = "gather") -> PrefixCacheOps:
    """Closed-form skipped-vs-executed prefill collectives for a request
    whose first ``hit_len`` positions came out of the prefix index and
    whose remaining ``suffix_len`` positions were prefilled (DESIGN.md
    §13).  ``chunk`` mirrors the scheduler's chunked prefill: the suffix
    splits at ``hit_len + k·chunk`` into ``ceil(suffix_len / chunk)``
    passes — exactly ``chunked_prefill_ops`` over the suffix, because
    per-chunk counts are chunk-length-invariant; ``chunk=None`` is the
    monolithic path (``prefill_whole(start=hit)``, one maximal chunk).
    Counts stay batch-invariant for the same reason every other count
    column in this module does: no count term carries a token or batch
    factor, only message bytes scale.

    ``hit_len = 0`` degenerates to ``executed == cold`` (a miss skips
    nothing), so callers can price a whole trace by mixing per-request
    hit lengths without special-casing misses.
    """
    if hit_len < 0 or suffix_len < 1:
        raise ValueError(
            f"need hit_len >= 0 and suffix_len >= 1 (the final position is "
            f"always prefilled), got {hit_len}/{suffix_len}")
    executed = chunked_prefill_ops(
        cfg, suffix_len, chunk if chunk else suffix_len, t, p, b=b,
        batch=batch, gather_mode=gather_mode)
    total = hit_len + suffix_len
    cold = chunked_prefill_ops(
        cfg, total, chunk if chunk else total, t, p, b=b, batch=batch,
        gather_mode=gather_mode)
    return PrefixCacheOps(hit_len=hit_len, suffix_len=suffix_len,
                          executed=executed, cold=cold)


# ---------------------------------------------------------------------------
# Disaggregated prefill/decode — the KV-page handoff transfer (DESIGN.md §14)
# ---------------------------------------------------------------------------


def kv_page_bytes(cfg: ModelConfig, page_size: int, b: int = 2) -> int:
    """Device bytes of ONE KV page across every layer: each layer's page
    holds ``page_size × kv_heads × head_dim`` K rows plus the same V rows,
    so the unit the disaggregated handoff ships is
    ``2 · L · page_size · kv · D · b`` — the exact footprint a
    ``KVPool`` page occupies in each backend's [L, P, ps, kv, D] pools."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    return 2 * cfg.num_layers * page_size * cfg.num_kv_heads \
        * cfg.head_dim * b


def kv_handoff_pages(prompt_len: int, page_size: int) -> int:
    """Closed-form page count of ONE request's prefill→decode handoff:
    exactly the prompt's FULL blocks — what ``PrefixIndex.insert`` indexes
    (a partial tail page keeps being rewritten by the suffix prefill and
    decode, so it never ships; the decode pool recomputes it).  This is the
    single source for both the predicted side (``kv_handoff_ops``,
    ``slo.predict_slo``'s interconnect term) and the measured side (the
    scheduler ships the pages a lookup of the freshly inserted prompt
    returns)."""
    if prompt_len < 0:
        raise ValueError(f"prompt_len must be >= 0, got {prompt_len}")
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    return prompt_len // page_size


def kv_handoff_ops(cfg: ModelConfig, pages: int, page_size: int, *,
                   b: int = 2, count: int = 1) -> List[CommOp]:
    """The disaggregated prefill→decode KV handoff as a modeled transfer
    (DESIGN.md §14): when the prefill pool finishes a prompt, its ``pages``
    full KV pages cross the pool interconnect to the decode pool — one
    send/recv pair per handed-off request, ``bytes = pages × page_bytes``
    with no wire-factor discount (a p2p copy ships every byte once, like
    the PP boundary rows).  The scheduler logs exactly these rows on each
    phase="handoff" StepRecord, so measured handoff transfers can be
    asserted equal to this closed form the same way boundary transfers
    match ``pp_comm_ops``."""
    if pages < 0:
        raise ValueError(f"pages must be >= 0, got {pages}")
    shape = (pages, 2 * cfg.num_layers * page_size
             * cfg.num_kv_heads * cfg.head_dim)
    return [CommOp("send", "handoff", count, shape, 2, b),
            CommOp("recv", "handoff", count, shape, 2, b)]


# ---------------------------------------------------------------------------
# Dynamic pipeline schedules — instruction counts + ticks (DESIGN.md §11)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PPScheduleStats:
    """Closed-form shape of a drain-first dynamic PP decode schedule
    (runtime/schedule.py): ``depth`` microbatch groups, each decoding
    ``rounds`` tokens through ``p`` stages, at most one StageForward per
    stage per tick, deepest stage first.

    Tick count: group g's round r occupies stage s at tick
    ``r·max(p, depth) + g + s`` — consecutive rounds of one group are
    ``max(p, depth)`` ticks apart (at depth ≥ p the pipeline is saturated
    and a group must wait for its own previous round; at depth < p the
    round trip through p stages dominates).  The last group's last round
    leaves stage p-1 at tick ``(rounds-1)·max(p, depth) + (depth-1) +
    (p-1)``, so the makespan is::

        M = rounds · max(p, depth) + min(p, depth) − 1

    Per-stage busy ticks are ``depth · rounds`` (every round visits every
    stage once), giving busy fraction ``depth·rounds / M`` → ``depth/p``
    of the stages' time at depth < p, → 1 as depth ≥ p — the bubble-
    occupancy term of ``slo.predict_slo(inflight=...)``.
    """
    p: int
    depth: int
    rounds: int

    @property
    def stage_forwards(self) -> Tuple[int, ...]:
        """StageForward instructions issued per stage."""
        return (self.depth * self.rounds,) * self.p

    @property
    def boundary_sends(self) -> int:
        """BoundarySend instructions (== BoundaryRecv): (p-1) links per
        round, each shipping the 2-tensor summand pair."""
        return (self.p - 1) * 2 * self.depth * self.rounds

    @property
    def samples(self) -> int:
        """SampleToken instructions — one per completed round."""
        return self.depth * self.rounds

    @property
    def ticks(self) -> int:
        """Schedule makespan M (0 when nothing decodes)."""
        if self.rounds == 0 or self.depth == 0:
            return 0
        return self.rounds * max(self.p, self.depth) \
            + min(self.p, self.depth) - 1

    @property
    def busy_fraction(self) -> float:
        """Per-stage (uniform) fraction of ticks spent busy."""
        t = self.ticks
        return self.depth * self.rounds / t if t else 0.0


def pp_schedule_stats(p: int, depth: int, rounds: int) -> PPScheduleStats:
    """Predicted instruction counts / ticks / occupancy of a dynamic PP
    decode schedule at in-flight ``depth`` over ``rounds`` decode rounds
    per group.  Pinned == the executed queue's instruction log and tick
    counters (tests/test_schedule.py) == the pp-occupancy bench series."""
    if p < 1 or depth < 0 or rounds < 0:
        raise ValueError(f"invalid schedule: p={p} depth={depth} "
                         f"rounds={rounds}")
    return PPScheduleStats(p=p, depth=depth, rounds=rounds)


def pp_schedule_ops(cfg: ModelConfig, depth: int, rounds: int, p: int, *,
                    t: int = 1, b: int = 2, group: int = 1) -> List[CommOp]:
    """Boundary transfers of a dynamic PP decode schedule (DESIGN.md §11).

    Every round still ships the PP closed form — (p-1) links × 2 tensors
    of [group, h/t] — so wire bytes *per token* are depth-invariant while
    tick throughput scales toward ×p: filling the bubble is free on the
    wire, which is the paper's PP-bytes-vs-latency tradeoff closing.
    """
    if p <= 1 or depth * rounds == 0:
        return []
    n = depth * rounds
    h = cfg.d_model // t
    return [CommOp(direction, "decode", (p - 1) * 2 * n,
                   (group * 1, h), p, b)
            for direction in ("send", "recv")]
