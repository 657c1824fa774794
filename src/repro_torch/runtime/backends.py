"""DecodeBackend: the slot-based decode protocol the scheduler drives.

Counterpart of ``repro.runtime.backends``: the single-device engine
(``make_backend("gspmd", ...)`` -> ``ModelBackend``), the explicit
tensor-parallel engine on virtual ranks (``make_backend("tp", ...)`` ->
``TPBackend``) and the pipeline / hybrid engine on virtual stages
(``make_backend("pp", ...)`` -> ``PPBackend``), core/parallel_exec.py.
``export_page`` / ``import_page`` (disaggregation) wait for A9.

The protocol:

  prefill_into_slots(prompts, slots) -> first greedy token per request
      (one batch-1 prefill per prompt at its true length, written into the
      slot's row of the cache, or into its pages when paged);
  decode_step(tokens [B], pos [B]) -> next greedy token of every slot
      (one step over the whole slot batch at per-sequence positions; free
      slots decode garbage the scheduler ignores);
  free_slots(slots).

Paged mode (``paged=True``) swaps the [L, num_slots, max_len, ...] slot
cache for [L, num_pages, page_size, ...] KV pages managed by a host-side
``KVPool``; prefill becomes chunked (``begin_prefill`` / ``prefill_chunk``
/ ``finish_prefill``), and ``decode_step`` extends each decoding slot's
pages and points every other slot's block-table row at scratch page 0.
Device caches are updated in place.

Context parallelism (``c`` > 1 on the tp and pp backends) changes only how
a request's prefill runs: the prompt pads to a multiple of c with token 0
and runs as one CP pass (``TPModel.cp_prefill`` / the pipeline's CP
stages), whose cache, assembled whole from the ring, lands in the slot's
row or is scattered into the slot's pages (``_seed_pages``) from a staging
cache of the padded width.  The pad rows' K/V sit past the prompt, where
decode overwrites them.  Decode is the c = 1 step.  CP and chunked prefill
are alternative long-prompt strategies: a c > 1 backend prefills whole.
"""
from __future__ import annotations

from typing import List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.core.commodel import DEFAULT_QUANT_CHUNK, CommOp, \
    chunked_prefill_ops, comm_ops_for
from repro_torch.core.parallel_exec import (PipelineEngine, TPModel,
                                            pad_to_multiple, shard_params)
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import get_model, resolve_device
from repro_torch.runtime.engine import check_params_device
from repro_torch.runtime.kvpool import KVPool
from repro_torch.runtime.schedule import DynamicPPQueue, FusedQueue


@runtime_checkable
class DecodeBackend(Protocol):
    """Slot-based decode interface the scheduler drives."""

    cfg: ModelConfig
    num_slots: int
    max_len: int
    t: int
    c: int
    p: int
    inflight: int
    group_size: int

    def prefill_into_slots(self, prompts: Sequence[np.ndarray],
                           slots: Sequence[int]) -> np.ndarray: ...

    def decode_step(self, tokens: np.ndarray,
                    pos: np.ndarray) -> np.ndarray: ...

    def free_slots(self, slots: Sequence[int]) -> None: ...

    def decode_comm_ops(self, batch: int = 1) -> List[CommOp]: ...

    def drain_transfers(self) -> dict: ...


def _seed_pages(pools, small, rows) -> None:
    """Scatter one rank's batch-1 contiguous cache {k, v: [L, 1, S, Hkv,
    D]} into its page pools {k, v: [L, P, ps, Hkv, D]} at the physical
    ``rows`` [S] of positions 0..S-1, in place: the CP prefill's hand-off
    into a slot's pages."""
    for key in ("k", "v"):
        L, P, ps, H, D = pools[key].shape
        pools[key].view(L, P * ps, H, D).index_copy_(1, rows,
                                                     small[key][:, 0])


class _BackendBase:
    """Slot and page bookkeeping, predicted per-step communication, and
    the device side every backend shares: one ``self.model`` pass per
    decode step or paged chunk (``Model`` or ``TPModel``), caches on
    ``self.device`` updated in place.  A subclass sets ``device``,
    ``model``, ``params`` and the cache, and writes a prefill into a slot
    (``_write_slot``); a c > 1 one runs its CP pass (``_cp_prefill``) and
    seeds a slot's pages from it (``_seed_slot_pages``)."""

    def __init__(self, cfg: ModelConfig, num_slots: int, max_len: int,
                 t: int, p: int, paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None, c: int = 1,
                 quant_collectives: Optional[str] = None,
                 quant_chunk: int = DEFAULT_QUANT_CHUNK):
        if not cfg.is_decoder:
            raise ValueError(f"{cfg.name} is encoder-only: no decode")
        if quant_collectives is not None and paged:
            raise ValueError(
                "quantized collectives cover the contiguous decode step; "
                "the paged engines run full-width")
        self.cfg = cfg
        self.quant = quant_collectives
        self.quant_chunk = int(quant_chunk)
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        if c < 1:
            raise ValueError(f"c must be >= 1, got {c}")
        self.t, self.c, self.p = int(t), int(c), int(p)
        self.inflight = 1
        self.group_size = self.num_slots
        self.paged = bool(paged)
        if self.paged:
            if cfg.family != "dense":
                raise ValueError(
                    f"paged mode covers dense attention; {cfg.name} is "
                    f"{cfg.family}")
            if cfg.sliding_window:
                raise ValueError(
                    "paged mode keeps every position (no ring wrap); "
                    f"{cfg.name} uses a sliding window — serve it contiguous")
            self.page_size = int(page_size)
            self.pages_per_slot = -(-self.max_len // self.page_size)
            if num_pages is None:
                # capacity parity with the contiguous slot cache, + the
                # reserved scratch page
                num_pages = 1 + self.num_slots * self.pages_per_slot
            self.pool = KVPool(num_pages, self.page_size)
            self.block_tables = np.zeros(
                (self.num_slots, self.pages_per_slot), np.int32)
            self._decodable: set = set()
            self._worst: dict = {}      # slot -> worst-case pages committed

    # -- paged bookkeeping --------------------------------------------------
    def _require_paged(self):
        if not self.paged:
            raise RuntimeError("chunked-prefill API needs paged=True")

    def _set_table(self, slot: int) -> None:
        table = self.pool.block_table(slot)
        row = np.zeros(self.pages_per_slot, np.int32)
        row[:len(table)] = table
        self.block_tables[slot] = row

    def _pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def _alloc_len(self, prompt_len: int) -> int:
        """Cache positions a prompt claims up front: its length, padded to
        a multiple of c on a CP backend."""
        return -(-prompt_len // self.c) * self.c

    def _worst_len(self, prompt_len: int, max_new_tokens: int) -> int:
        return max(self._alloc_len(prompt_len),
                   prompt_len + max_new_tokens - 1)

    def can_admit(self, prompt_len: int, max_new_tokens: int = 1) -> bool:
        """True when the pool covers this request's worst case (prompt +
        max_new_tokens - 1 positions, or the CP-padded prompt if longer)
        on top of every live request's committed growth — conservative
        admission: a decode step can never run out of pages."""
        self._require_paged()
        committed = sum(
            max(0, self._worst.get(o, 0) - len(self.pool.block_table(o)))
            for o in self.pool.owners() if 0 <= o < self.num_slots)
        need = self._pages_for(self._worst_len(prompt_len, max_new_tokens))
        return self.pool.free_pages - committed >= need

    def begin_prefill(self, slot: int, prompt_len: int,
                      max_new_tokens: int = 1) -> None:
        """Allocate the slot's pages for a new prompt (CP-padded when
        c > 1) and commit its worst-case decode growth (see
        ``can_admit``)."""
        self._require_paged()
        self.pool.free(slot)               # the slot may be reused
        self._decodable.discard(slot)
        self.pool.allocate(slot, self._alloc_len(prompt_len))
        self._worst[slot] = self._pages_for(
            self._worst_len(prompt_len, max_new_tokens))
        self._set_table(slot)

    def prefill_chunk(self, slot: int, tokens, start: int) -> int:
        """One chunked-prefill pass for ``tokens`` at positions
        start..start+S-1; returns the greedy token of its last position."""
        self._require_paged()
        if self.c > 1:
            raise RuntimeError(
                "chunked prefill and context parallelism are alternative "
                "long-prompt strategies; a c > 1 backend prefills whole "
                "(prefill_whole)")
        chunk = np.asarray(tokens, np.int32)[None, :]
        pos = np.asarray([start], np.int32)
        bt = self.block_tables[slot:slot + 1]
        logits = self._paged_call(chunk, pos, bt)
        return int(np.argmax(logits[0]))

    def prefill_whole(self, slot: int, tokens) -> int:
        """Prefill a whole prompt into the slot's allocated pages: one
        chunk at c = 1, one CP pass at c > 1 whose cache is scattered into
        the pages; returns the first greedy token."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if self.c == 1:
            return self.prefill_chunk(slot, tokens, 0)
        self._require_paged()
        padded, last = self._pad_prompt(tokens)
        S = padded.shape[1]
        with torch.inference_mode():
            logits, small = self._cp_prefill(padded, last, S)
            lp = np.arange(S)
            table = self.block_tables[slot]
            rows = self._tensor(table[lp // self.page_size] * self.page_size
                                + lp % self.page_size).long()
            self._seed_slot_pages(small, rows)
        return int(torch.argmax(logits[0]))

    def finish_prefill(self, slot: int) -> None:
        """Mark a fully prefilled slot decode-eligible."""
        self._require_paged()
        self._decodable.add(slot)

    def _paged_decode(self, tokens, pos) -> np.ndarray:
        """Extend the decoding slots' pages to cover the incoming position,
        then one paged pass (S = 1) over the whole slot batch; every other
        slot's table row points at scratch page 0."""
        pos = np.asarray(pos)
        for slot in sorted(self._decodable):
            self.pool.extend(slot, int(pos[slot]) + 1)
            self._set_table(slot)
        bt = self.block_tables.copy()
        for slot in range(self.num_slots):
            if slot not in self._decodable:
                bt[slot] = 0                # scratch page (kvpool.py)
        logits = self._paged_call(
            np.asarray(tokens, np.int32)[:, None],
            np.asarray(pos, np.int32), bt)
        return np.asarray(np.argmax(logits, -1), np.int32)

    # -- predicted communication --------------------------------------------
    def _itemsize(self) -> int:
        return torch_dtype(self.cfg.dtype).itemsize

    def chunk_comm_ops(self, chunk_len: int, batch: int = 1) -> List[CommOp]:
        """Predicted collectives of ONE prefill chunk (the per-chunk rows of
        ``commodel.chunked_prefill_ops``)."""
        return chunked_prefill_ops(
            self.cfg, chunk_len, chunk_len, self.t, self.p, batch=batch,
            b=self._itemsize(), gather_mode="allgather")

    def decode_comm_ops(self, batch: int = 1) -> List[CommOp]:
        """Predicted collectives of ONE decode step over ``batch`` rows: the
        decode rows of ``comm_ops_for`` at s_d = 2 — with quantized
        collectives, the decomposed rows (an f32 abs-max all-reduce and the
        narrow payload hops per layer all-reduce)."""
        ops = comm_ops_for(self.cfg, 1, 2, self.t, self.p, c=self.c,
                           batch=batch, b=self._itemsize(),
                           gather_mode="allgather", quant=self.quant,
                           quant_chunk=self.quant_chunk)
        return [o for o in ops if o.phase == "decode"]

    def prefill_comm_ops(self, prompt_len: int,
                         batch: int = 1) -> List[CommOp]:
        """Predicted collectives of ONE whole prefill pass of a
        ``prompt_len``-token prompt: at c > 1 the ring rows of
        ``commodel.cp_comm_ops`` and the TP/PP rows at the padded
        ceil(prompt_len / c) shard each worker runs."""
        ops = comm_ops_for(self.cfg, prompt_len, 1, self.t, self.p,
                           c=self.c, batch=batch, b=self._itemsize(),
                           gather_mode="allgather")
        return [o for o in ops if o.phase == "prefill"]

    def drain_transfers(self) -> dict:
        """Inter-stage bytes moved since the last drain (PP only)."""
        return {"count": 0, "bytes": 0}

    def make_queue(self):
        return FusedQueue(self)

    def free_slots(self, slots: Sequence[int]) -> None:
        for s in slots:
            if not 0 <= s < self.num_slots:
                raise IndexError(f"slot {s} out of range")
        if self.paged:
            for s in slots:
                self.pool.free(s)           # no-op for a never-admitted slot
                self.block_tables[s] = 0
                self._decodable.discard(s)
                self._worst.pop(s, None)

    def prefill_into_slots(self, prompts, slots) -> np.ndarray:
        """Admit requests: one batch-1 prefill per prompt at its true length
        (row-wise identical to serving it alone), written into the slot's
        cache row — or, paged, straight into its pages as one chunk.
        Returns the first greedy token per request."""
        first = np.zeros(len(slots), np.int32)
        for i, (prompt, slot) in enumerate(zip(prompts, slots)):
            prompt = np.asarray(prompt, np.int32).reshape(-1)
            if self.paged:
                self.begin_prefill(slot, len(prompt))
                first[i] = self.prefill_whole(slot, prompt)
                self.finish_prefill(slot)
            else:
                first[i] = self._prefill_slot(prompt, slot)
        return first

    def _pad_prompt(self, prompt):
        """(the prompt as [1, S] on the device, padded with token 0 to a
        multiple of c, the index of its true last position).  The padded
        prompt must fit max_len, except on a sliding-window model, whose
        ring cache keeps the last W positions (the scheduler's admission
        waives it too)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        padded = pad_to_multiple(self._tensor(prompt)[None], self.c)
        if not self.paged and padded.shape[1] > self.max_len \
                and not self.cfg.sliding_window:
            raise ValueError(f"CP-padded prompt ({padded.shape[1]}) exceeds "
                             f"max_len {self.max_len}")
        return padded, len(prompt) - 1

    def _cp_prefill(self, padded, last: int, cache_w: int):
        """(logits [1, v], the batch-1 cache of width ``cache_w``) of one CP
        pass over a padded prompt [1, S]."""
        raise NotImplementedError

    def _seed_slot_pages(self, small, rows) -> None:
        """Scatter a CP pass's cache into the page ``rows`` of a slot."""
        raise NotImplementedError

    # -- the device side: one self.model pass per step or chunk ---------------
    def _init_device_cache(self) -> None:
        if self.paged:
            self.cache = self.model.init_paged_cache(
                self.pool.num_pages, self.page_size, self.device)
        else:
            self.cache = self.model.init_cache(self.num_slots, self.max_len,
                                               self.device)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _write_slot(self, small, slot: int) -> None:
        """Copy a batch-1 prefill cache into the slot's cache row."""
        raise NotImplementedError

    @torch.inference_mode()
    def _prefill_slot(self, prompt, slot: int) -> int:
        if self.c > 1:
            padded, last = self._pad_prompt(prompt)
            logits, small = self._cp_prefill(
                padded, last, self.model.cache_width(self.max_len))
        else:
            logits, small, _ = self.model.prefill(
                self.params, self._tensor(prompt)[None, :], self.max_len)
        self._write_slot(small, slot)
        return int(torch.argmax(logits[0]))

    @torch.inference_mode()
    def _paged_call(self, tokens, pos, bt) -> np.ndarray:
        """(logits [B, v]) of one paged pass; updates the cache in place."""
        logits, self.cache = self.model.paged_step(
            self.params, self.cache, self._tensor(tokens), self._tensor(pos),
            self._tensor(bt))
        return logits.float().cpu().numpy()

    @torch.inference_mode()
    def decode_step(self, tokens, pos) -> np.ndarray:
        if self.paged:
            return self._paged_decode(tokens, pos)
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, self._tensor(tokens), self._tensor(pos))
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()


class ModelBackend(_BackendBase):
    """The single-device ``Model`` path behind the DecodeBackend protocol:
    one pass per decode step, per-sequence positions, caches on the device
    updated in place.  ``device`` defaults to the CUDA card."""

    def __init__(self, cfg: ModelConfig, params, num_slots: int,
                 max_len: int = 256, paged: bool = False,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        super().__init__(cfg, num_slots, max_len, t=1, p=1, paged=paged,
                         page_size=page_size, num_pages=num_pages)
        check_params_device(params, self.device)
        self.model = get_model(cfg)
        self.params = params
        self._init_device_cache()

    def _write_slot(self, small, slot: int) -> None:
        # every cache family keeps the batch on axis 1 of each leaf
        for key, val in small.items():
            self.cache[key][:, slot] = val[:, 0]


class TPBackend(_BackendBase):
    """The explicit TP engine (``core.parallel_exec.TPModel``, t virtual
    ranks on one device) behind the protocol: (2L+1) all-reduces + 1 logits
    all-gather per decode step whatever the slot count, each logged on
    ``self.model.group``.  ``params`` are the single-device weights; the
    backend keeps their per-rank shards.  Each rank has its own cache
    [L, num_slots, W, Hkv/t, D], or, paged, its own page pool
    [L, P, ps, Hkv/t, D] under the one shared ``KVPool`` and block table.
    ``c`` > 1 prefills on c CP workers besides (t = 1: the pure-CP
    layout).  ``quant_collectives`` ("int8" | "fp8" | "int4") quantizes
    the contiguous decode step's layer all-reduces.  ``device`` defaults to
    the CUDA card."""

    def __init__(self, cfg: ModelConfig, params, num_slots: int,
                 max_len: int = 256, t: int = 2, paged: bool = False,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 c: int = 1, quant_collectives: Optional[str] = None,
                 quant_chunk: int = DEFAULT_QUANT_CHUNK, device=None):
        self.device = resolve_device(device)
        super().__init__(cfg, num_slots, max_len, t=t, p=1, paged=paged,
                         page_size=page_size, num_pages=num_pages, c=c,
                         quant_collectives=quant_collectives,
                         quant_chunk=quant_chunk)
        check_params_device(params, self.device)
        self.model = TPModel(cfg, t, quant=self.quant,
                             quant_chunk=self.quant_chunk, c=c)
        self.params = shard_params(cfg, params, t)
        self._init_device_cache()

    def _write_slot(self, small, slot: int) -> None:
        for rank, part in zip(self.cache, small):
            for key in ("k", "v"):
                rank[key][:, slot] = part[key][:, 0]

    def _cp_prefill(self, padded, last: int, cache_w: int):
        return self.model.cp_prefill(self.params, padded, last, cache_w)

    def _seed_slot_pages(self, small, rows) -> None:
        for pools, part in zip(self.cache, small):
            _seed_pages(pools, part, rows)


class PPBackend(_BackendBase):
    """The pipeline engine (``core.parallel_exec.PipelineEngine``: pure PP
    at t = 1, hybrid TP x PP at t > 1, p virtual stages on one device)
    behind the protocol: one decode step is one token through all p
    stages, with (p-1)·2 logged boundary transfers.

    ``inflight`` >= 1 splits the slots into ``inflight`` microbatch groups
    of ``num_slots // inflight`` rows.  Contiguous: each group has its own
    caches on every stage (``gcaches[g][s]``, per-rank [L_s, G, W, Hkv/t,
    D]), so groups can sit at different stages at once.  Paged: each stage
    has its own page pool and all stages share the one ``KVPool`` block
    table; rounds stay apart through their disjoint table rows.  The
    ``DynamicPPQueue`` that ``make_queue`` returns drives a group's round
    stage by stage through ``start_round`` / ``run_stage`` /
    ``send_boundary``.  ``quant_collectives`` quantizes the contiguous
    decode step's layer all-reduces.  ``c`` > 1 shards each prefill over
    c CP workers per stage.  ``params`` are the single-device weights;
    ``device`` defaults to the CUDA card."""

    def __init__(self, cfg: ModelConfig, params, num_slots: int,
                 max_len: int = 256, t: int = 1, p: int = 2,
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None, c: int = 1,
                 inflight: int = 1,
                 quant_collectives: Optional[str] = None,
                 quant_chunk: int = DEFAULT_QUANT_CHUNK, device=None):
        if p < 2:
            raise ValueError(f"pp backend needs p >= 2, got p={p}")
        self.device = resolve_device(device)
        super().__init__(cfg, num_slots, max_len, t=t, p=p, paged=paged,
                         page_size=page_size, num_pages=num_pages, c=c,
                         quant_collectives=quant_collectives,
                         quant_chunk=quant_chunk)
        if inflight < 1 or num_slots % inflight:
            raise ValueError(
                f"inflight must divide num_slots: got inflight={inflight}, "
                f"num_slots={num_slots}")
        self.inflight = int(inflight)
        self.group_size = self.num_slots // self.inflight
        self.engine = PipelineEngine(
            cfg, t=t, p=p, c=c, quant_collectives=self.quant,
            quant_chunk=self.quant_chunk, device=self.device)
        self.staged = self.engine.prepare(params)
        self._decode_fns = self.engine.decode_stage_fns()
        self._paged_fns = self.engine.paged_stage_fns()
        if self.paged:
            self.caches = self.engine.init_paged_cache(self.pool.num_pages,
                                                       self.page_size)
        else:
            self.cache_w = self.engine.cache_width(self.max_len)
            self.gcaches = [self.engine.init_cache(self.group_size,
                                                   self.max_len)
                            for _ in range(self.inflight)]
        self._drained = 0              # transfer-log cursor

    def _first_token(self, logits) -> np.ndarray:
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    def _cp_prefill(self, padded, last: int, cache_w: int):
        return self.engine.prefill_with_cache(self.staged, padded, cache_w,
                                              last)

    def _seed_slot_pages(self, small, rows) -> None:
        for stage, part in zip(self.caches, small):
            for pools, piece in zip(stage, part):
                _seed_pages(pools, piece, rows)

    @torch.inference_mode()
    def _prefill_slot(self, prompt, slot: int) -> int:
        if self.c > 1:
            padded, last = self._pad_prompt(prompt)
            logits, small = self._cp_prefill(padded, last, self.cache_w)
        else:
            logits, small = self.engine.prefill_with_cache(
                self.staged, self._tensor(prompt)[None, :], self.cache_w)
        g, row = divmod(slot, self.group_size)
        for stage, part in zip(self.gcaches[g], small):
            for rank, piece in zip(stage, part):
                for key in ("k", "v"):
                    rank[key][:, row] = piece[key][:, 0]
        return int(torch.argmax(logits[0]))

    @torch.inference_mode()
    def _paged_call(self, tokens, pos, bt) -> np.ndarray:
        phase = "decode" if np.shape(tokens)[1] == 1 else "prefill"
        logits, self.caches = self.engine.paged_pass(
            self.staged, self.caches, self._tensor(tokens), self._tensor(pos),
            self._tensor(bt), phase)
        return logits.float().cpu().numpy()

    @torch.inference_mode()
    def decode_step(self, tokens, pos) -> np.ndarray:
        """One decode step of every group, group after group."""
        if self.paged:
            return self._paged_decode(tokens, pos)
        tokens, pos = np.asarray(tokens), np.asarray(pos)
        out = np.zeros(self.num_slots, np.int32)
        G = self.group_size
        for g in range(self.inflight):
            lo = g * G
            logits, self.gcaches[g] = self.engine.decode_once(
                self.staged, self.gcaches[g], self._tensor(tokens[lo:lo + G]),
                self._tensor(pos[lo:lo + G]))
            out[lo:lo + G] = self._first_token(logits)
        return out

    # -- the instruction queue's surface (runtime/schedule.py) --------------
    def make_queue(self):
        """The dynamic per-stage instruction queue at depth ``inflight``."""
        return DynamicPPQueue(self)

    @torch.inference_mode()
    def start_round(self, g: int, tokens, pos):
        """(stage-0 input, the group's positions, block tables or None) of
        one decode round of group ``g``.  Paged, the group's decoding slots'
        pages are extended here, before any instruction issues; the other
        rows of the group point at scratch page 0."""
        G = self.group_size
        lo = g * G
        toks = np.asarray(tokens, np.int32)[lo:lo + G]
        pos_g = self._tensor(np.asarray(pos)[lo:lo + G])
        if not self.paged:
            return self.engine.feed_tokens(toks), pos_g, None
        for slot in sorted(self._decodable):
            if lo <= slot < lo + G:
                self.pool.extend(slot, int(pos[slot]) + 1)
                self._set_table(slot)
        bt = self.block_tables[lo:lo + G].copy()
        for i, slot in enumerate(range(lo, lo + G)):
            if slot not in self._decodable:
                bt[i] = 0                   # scratch page (kvpool.py)
        return self.engine.feed_tokens(toks[:, None]), pos_g, self._tensor(bt)

    @torch.inference_mode()
    def run_stage(self, g: int, s: int, x, pos, bt=None):
        """One ``StageForward``: stage s against group g's caches
        (contiguous) or the stage's page pool (paged)."""
        if self.paged:
            out, self.caches[s] = self._paged_fns[s](
                self.staged[s], self.caches[s], x, pos, bt)
        else:
            out, self.gcaches[g][s] = self._decode_fns[s](
                self.staged[s], self.gcaches[g][s], x, pos)
        return out

    def send_boundary(self, out, s: int):
        """One ``BoundarySend``/``BoundaryRecv`` pair: stage s's boundary to
        stage s + 1, logged as decode transfers."""
        return self.engine.send_boundary(out, s, phase="decode")

    def drain_transfers(self) -> dict:
        recs = self.engine.transfers[self._drained:]
        self._drained = len(self.engine.transfers)
        return {"count": sum(r.count for r in recs),
                "bytes": sum(r.bytes for r in recs)}


def make_backend(kind: str, cfg: ModelConfig, params, num_slots: int,
                 max_len: int = 256, t: int = 1, p: int = 1,
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None, c: int = 1,
                 inflight: int = 1,
                 quant_collectives: Optional[str] = None,
                 quant_chunk: int = DEFAULT_QUANT_CHUNK,
                 device=None) -> DecodeBackend:
    """Backend factory keyed by engine kind: "gspmd" is the single-device
    engine (t = p = 1), "tp" the explicit TP engine on t >= 2 virtual
    ranks or c >= 2 CP workers (t = 1, c > 1: the pure-CP layout), "pp"
    the pipeline engine on p >= 2 virtual stages (hybrid at t >= 2); c > 1
    adds context-parallel prefill to the explicit engines.
    ``inflight`` > 1 splits the slots into microbatch groups on the pp
    backend's dynamic queue; the fused engines have no pipeline bubble to
    fill and reject it.  ``quant_collectives`` needs the explicit engines'
    hand-placed all-reduces; the single-device engine rejects it."""
    kw = dict(paged=paged, page_size=page_size, num_pages=num_pages,
              device=device)
    if kind != "pp" and inflight != 1:
        raise ValueError(
            "in-flight microbatching fills the PP decode bubble; the "
            f"{kind!r} backend runs a fused step — inflight must be 1")
    if kind == "gspmd":
        if t != 1 or p != 1:
            raise ValueError(f"the gspmd backend is one device: got t={t} "
                             f"p={p}")
        if c > 1:
            raise ValueError(
                "context parallelism needs the explicit engines — use the "
                "tp (single-stage) or pp backend with c > 1")
        if quant_collectives is not None:
            raise ValueError(
                "quantized collectives need the explicit engines' "
                "hand-placed all-reduces; use the tp backend")
        return ModelBackend(cfg, params, num_slots, max_len, **kw)
    qkw = dict(quant_collectives=quant_collectives, quant_chunk=quant_chunk)
    if kind == "tp":
        if t < 2 and c < 2:
            raise ValueError(
                f"tp backend needs t >= 2 or c >= 2, got t={t} c={c}")
        return TPBackend(cfg, params, num_slots, max_len, t=t, c=c, **qkw,
                         **kw)
    if kind == "pp":
        return PPBackend(cfg, params, num_slots, max_len, t=t, p=p, c=c,
                         inflight=inflight, **qkw, **kw)
    raise ValueError(f"unknown backend kind: {kind!r}")
