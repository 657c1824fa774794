"""DecodeBackend: the slot-based decode protocol the scheduler drives.

Counterpart of ``repro.runtime.backends``: the single-device engine
(``make_backend("gspmd", ...)`` -> ``ModelBackend``), the explicit
tensor-parallel engine on virtual ranks (``make_backend("tp", ...)`` ->
``TPBackend``) and the pipeline / hybrid engine on virtual stages
(``make_backend("pp", ...)`` -> ``PPBackend``), core/parallel_exec.py.

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
row or is scattered into the slot's pages (``seed_cp_pages``) from a staging
cache of the padded width.  The pad rows' K/V sit past the prompt, where
decode overwrites them.  Decode is the c = 1 step.  CP and chunked prefill
are alternative long-prompt strategies: a c > 1 backend prefills whole.

Prefix caching (``prefix_cache=True``, paged, c = 1) attaches a
``PrefixIndex`` to the pool: ``begin_prefill_cached`` adopts the longest
cached prefix's pages and ``prefill_whole(..., start=hit)`` runs one
suffix chunk at query offset ``hit``; every pool claim goes through
``_claim_guard`` (LRU eviction under pressure) and every extend is
followed by ``_apply_cow``, which replays the pool's copy-on-write events
as in-place device page copies (``_copy_page``).  ``pool`` / ``owner_base``
let two backends share one ``KVPool`` under disjoint owner ranges (the
disaggregated prefill and decode pools); page content crosses between
their device pools through ``export_page`` / ``import_page``.

Real ranks (``place``, a ``core.comm.RankPlace`` from
``core.comm.dist_groups(t, p, c=c)``): the tp and pp backends run one
process per rank and card, each keeping only its rank's (and stage's)
shard of the weights and of the caches or page pools; every process
drives the same scheduler, whose clock is rank 0's
(``runtime.scheduler``).  The host-side slot and page bookkeeping is the
same on every rank.  At c > 1 each process runs its CP worker's shard of
a padded prompt and writes or seeds its whole cache, assembled by the
ring, and decodes replicated over cp.  A backend's ``drain_transfers``
then counts the hops this process sent.  The page export and import of
the disaggregated pools stay on virtual ranks.
"""
from __future__ import annotations

from typing import List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config.base import ModelConfig
from repro_torch.core.commodel import DEFAULT_QUANT_CHUNK, CommOp, \
    chunked_prefill_ops, comm_ops_for
from repro_torch.core.parallel_exec import (PipelineEngine, TPModel,
                                            pad_to_multiple, shard_params)
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import get_model, resolve_device
from repro_torch.runtime.engine import check_params_device
from repro_torch.runtime.kvpool import KVPool
from repro_torch.runtime.prefix_index import PrefixIndex
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


def _check_place(place, t: int, c: int, p: int) -> None:
    """Raise unless ``place`` (None: virtual ranks) is a rank of a world
    of exactly t·c·p processes placed at (t, c, p)."""
    if place is None:
        return
    if (place.t, place.c, place.p) != (t, c, p):
        raise ValueError(f"a rank placed at (t, c, p) = ({place.t}, "
                         f"{place.c}, {place.p}) for a backend of "
                         f"({t}, {c}, {p})")
    if dist.get_world_size() != t * c * p:
        raise ValueError(f"a world of {dist.get_world_size()} ranks for "
                         f"t·c·p = {t * c * p}")


def _device_of(place, device):
    """A backend's device: the rank's own on real ranks."""
    if place is None:
        return resolve_device(device)
    if device is not None and torch.device(device) != place.device:
        raise ValueError(f"device {device} is not the rank's {place.device}")
    return place.device


def seed_cp_pages(stages, parts, table, n: int, page_size: int) -> None:
    """Scatter a CP prefill's batch-1 caches into one slot's pages, in
    place: the CP pass's hand-off.  ``parts`` [stage][rank] {k, v: [L, 1,
    n, Hkv, D]} land in the page pools ``stages`` [stage][rank] {k, v:
    [L, P, page_size, Hkv, D]} at positions 0..n-1 of the slot's block
    table row ``table`` [pages] (a tensor).  A stage that another process
    holds (None) is skipped."""
    lp = torch.arange(n, device=table.device)
    rows = table.long()[lp // page_size] * page_size + lp % page_size
    for stage, part in zip(stages, parts):
        if stage is None:
            continue
        for pools, piece in zip(stage, part):
            for key in ("k", "v"):
                L, P, ps, H, D = pools[key].shape
                pools[key].view(L, P * ps, H, D).index_copy_(
                    1, rows, piece[key][:, 0])


class _BackendBase:
    """Slot and page bookkeeping, predicted per-step communication, and
    the device side every backend shares: one ``self.model`` pass per
    decode step or paged chunk (``Model`` or ``TPModel``), caches on
    ``self.device`` updated in place.  A subclass sets ``device``,
    ``model``, ``params`` and the cache, writes a prefill into a slot
    (``_write_slot``) and lists its device page pools (``_page_pools``,
    which page copies and the handoff walk); a c > 1 one runs its CP pass
    (``_cp_prefill``) and seeds a slot's pages from it
    (``_page_stages``, ``seed_cp_pages``)."""

    def __init__(self, cfg: ModelConfig, num_slots: int, max_len: int,
                 t: int, p: int, paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None, c: int = 1,
                 quant_collectives: Optional[str] = None,
                 quant_chunk: int = DEFAULT_QUANT_CHUNK,
                 prefix_cache: bool = False,
                 pool: Optional[KVPool] = None, owner_base: int = 0,
                 place=None):
        _check_place(place, t, c, p)
        if not cfg.is_decoder:
            raise ValueError(f"{cfg.name} is encoder-only: no decode")
        if quant_collectives is not None and paged:
            raise ValueError(
                "quantized collectives cover the contiguous decode step; "
                "the paged engines run full-width")
        if prefix_cache and not paged:
            raise ValueError(
                "prefix caching shares KV pages across requests — "
                "construct the backend with paged=True")
        if prefix_cache and c > 1:
            raise ValueError(
                "a cache hit prefills only the novel suffix, which needs "
                "the chunked (offset) prefill path; CP prefills the whole "
                "sequence at once — use c=1")
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
        if owner_base < 0:
            raise ValueError(
                f"owner_base must be >= 0 (negative ids belong to the "
                f"prefix index), got {owner_base}")
        self._owner_base = int(owner_base)
        if pool is not None and not paged:
            raise ValueError("a shared KVPool needs paged=True")
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
            if pool is not None:
                # two backends on one page space (disaggregated pools):
                # their block tables name pages of one host allocator,
                # while each keeps its own device page pools
                if pool.page_size != self.page_size:
                    raise ValueError(
                        f"shared pool page_size {pool.page_size} != "
                        f"backend page_size {self.page_size}")
                self.pool = pool
            else:
                if num_pages is None:
                    # capacity parity with the contiguous slot cache, + the
                    # reserved scratch page
                    num_pages = 1 + self.num_slots * self.pages_per_slot
                self.pool = KVPool(num_pages, self.page_size)
            self.block_tables = np.zeros(
                (self.num_slots, self.pages_per_slot), np.int32)
            self._decodable: set = set()
            self._worst: dict = {}      # slot -> worst-case pages committed
        self.prefix_index = PrefixIndex(self.pool) if prefix_cache else None
        self.place = place

    # -- paged bookkeeping --------------------------------------------------
    def _require_paged(self):
        if not self.paged:
            raise RuntimeError("chunked-prefill API needs paged=True")

    def _owner(self, slot: int) -> int:
        """Pool owner id of a local slot: ``owner_base + slot`` (backends
        sharing one KVPool claim disjoint owner ranges)."""
        return self._owner_base + slot

    def _set_table(self, slot: int) -> None:
        table = self.pool.block_table(self._owner(slot))
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

    def can_admit(self, prompt_len: int, max_new_tokens: int = 1,
                  optimistic: bool = False) -> bool:
        """True when the pool covers this request's worst case (prompt +
        max_new_tokens - 1 positions, or the CP-padded prompt if longer)
        on top of the committed growth of every live request of this
        backend — conservative admission: a decode step can never run out
        of pages.  ``optimistic=True`` gates only on the pages the prompt
        (or recompute prefix) claims now; the scheduler then covers decode
        growth by preemption.  Pages that only the prefix index pins count
        as free: ``_claim_guard`` reclaims them on demand."""
        self._require_paged()
        free = self.pool.free_pages + (self.prefix_index.reclaimable_pages()
                                       if self.prefix_index else 0)
        if optimistic:
            return free >= self._pages_for(self._alloc_len(prompt_len))
        # the index's owners (negative) never grow, and a pool-sharing
        # sibling backend's live pages are already out of ``free``
        committed = sum(
            max(0, self._worst.get(o - self._owner_base, 0)
                - len(self.pool.block_table(o)))
            for o in self.pool.owners()
            if 0 <= o - self._owner_base < self.num_slots)
        need = self._pages_for(self._worst_len(prompt_len, max_new_tokens))
        return free - committed >= need

    def _claim_guard(self, fn):
        """Run a pool claim; under pressure evict LRU cached prefixes until
        it succeeds, or let the MemoryError reach the scheduler (which
        preempts) once the index is empty."""
        while True:
            try:
                return fn()
            except MemoryError:
                if self.prefix_index is None \
                        or not self.prefix_index.evict_one():
                    raise

    def _apply_cow(self) -> None:
        """Replay the pool's pending copy-on-write events as device page
        copies; runs after every ``pool.extend``, before the next pass
        writes the privatised page."""
        for ev in self.pool.take_cow_events():
            self._copy_page(ev.src, ev.dst)

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy physical page src -> dst in every device pool of this
        backend (every rank, every stage), in place.  The whole page is
        copied: rows past the owner's length are never read."""
        with torch.inference_mode():
            for _, pools in self._page_pools():
                for key in ("k", "v"):
                    pools[key][:, dst].copy_(pools[key][:, src])

    # -- KV-page handoff (disaggregated pools) -------------------------------
    def _page_pools(self):
        """[(layer offset, {k, v: [L_part, P, ps, Hkv_part, D]}) ...] of
        every device page pool of this backend, in rank order within each
        group of layers: the pieces one exported page is cut into."""
        raise NotImplementedError

    def _require_virtual(self, what: str) -> None:
        if self.place is not None:
            raise NotImplementedError(
                f"{what} across real ranks is not supported: each "
                "process holds only its rank's slice of a page")

    def export_page(self, page: int) -> dict:
        """Physical ``page``'s K/V rows as host tensors {k, v: [L, ps, Hkv,
        D]} of the model's dtype — CPU ``torch`` tensors, so bfloat16 rows
        keep their bits (numpy has no bfloat16).  The ranks' head slices
        are concatenated over the head axis, the stages' layers over the
        layer axis: the unit ``commodel.kv_handoff_ops`` prices."""
        self._require_paged()
        self._require_virtual("a page export")
        with torch.inference_mode():
            out = {}
            for key in ("k", "v"):
                groups: dict = {}
                for lo, pools in self._page_pools():
                    groups.setdefault(lo, []).append(pools[key][:, page])
                out[key] = torch.cat(
                    [torch.cat(parts, dim=2) for _, parts in
                     sorted(groups.items())], dim=0).cpu()
        return out

    def import_page(self, page: int, data: dict) -> int:
        """Land exported rows {k, v: [L, ps, Hkv, D]} (CPU tensors or
        numpy arrays, cast to the model's type) at physical ``page`` of
        this backend's device pools, split back over stages and ranks;
        returns the device bytes written."""
        self._require_paged()
        self._require_virtual("a page import")
        dt = torch_dtype(self.cfg.dtype)
        total = 0
        with torch.inference_mode():
            for key in ("k", "v"):
                rows = data[key]
                if not isinstance(rows, torch.Tensor):
                    rows = torch.from_numpy(np.array(rows))
                rows = rows.to(self.device, dt)
                h0: dict = {}
                for lo, pools in self._page_pools():
                    dst = pools[key][:, page]
                    L_s, _, H_s, _ = dst.shape
                    h = h0.get(lo, 0)
                    dst.copy_(rows[lo:lo + L_s, :, h:h + H_s])
                    h0[lo] = h + H_s
                    total += dst.numel() * dst.element_size()
        return total

    def begin_prefill(self, slot: int, prompt_len: int,
                      max_new_tokens: int = 1) -> None:
        """Allocate the slot's pages for a new prompt (CP-padded when
        c > 1) and commit its worst-case decode growth (see
        ``can_admit``)."""
        self._require_paged()
        self.pool.free(self._owner(slot))   # the slot may be reused
        self._decodable.discard(slot)
        self._claim_guard(
            lambda: self.pool.allocate(self._owner(slot),
                                       self._alloc_len(prompt_len)))
        self._worst[slot] = self._pages_for(
            self._worst_len(prompt_len, max_new_tokens))
        self._set_table(slot)

    def begin_prefill_cached(self, slot: int, prompt,
                             max_new_tokens: int = 1) -> int:
        """Cache-aware admission: adopt the longest cached prefix's pages
        into the slot and extend to the whole prompt (fresh pages for the
        suffix; a partly shared last page is copied on write here, before
        the suffix chunk writes it — a fully cached prompt's hit is capped
        one position short, so its last page is always such a page).
        Returns the hit length (0: a miss, a plain ``begin_prefill``); the
        caller prefills positions hit..prompt_len-1."""
        self._require_paged()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prefix_index is None:
            self.begin_prefill(slot, len(prompt), max_new_tokens)
            return 0
        self.pool.free(self._owner(slot))
        self._decodable.discard(slot)
        hit = self.prefix_index.lookup(prompt)
        if not hit.hit:
            self.begin_prefill(slot, len(prompt), max_new_tokens)
            return 0
        self.pool.adopt(self._owner(slot), hit.pages, hit.length)
        try:
            self._claim_guard(
                lambda: self.pool.extend(self._owner(slot),
                                         self._alloc_len(len(prompt))))
        except MemoryError:
            self.pool.free(self._owner(slot))   # extend claims atomically
            raise
        self._apply_cow()
        self._worst[slot] = self._pages_for(
            self._worst_len(len(prompt), max_new_tokens))
        self._set_table(slot)
        return hit.length

    def cache_prefix(self, slot: int, tokens) -> int:
        """Index a fully prefilled slot's full prompt blocks (its first
        pages, which decode never rewrites); returns the entries created
        (0 without an index)."""
        if not self.paged or self.prefix_index is None:
            return 0
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        return self.prefix_index.insert(
            tokens, self.pool.block_table(self._owner(slot)))

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
        return int(self._paged_tokens(chunk, pos, bt)[0])

    def prefill_whole(self, slot: int, tokens, start: int = 0) -> int:
        """Prefill a whole prompt into the slot's allocated pages: one
        chunk at c = 1, one CP pass at c > 1 whose cache is scattered into
        the pages; returns the first greedy token.  ``start`` > 0 (a cache
        hit's length, from ``begin_prefill_cached``) computes only
        positions start.. — one suffix chunk at query offset ``start``."""
        self._require_paged()
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if not 0 <= start < len(tokens):
            raise ValueError(
                f"start {start} outside [0, {len(tokens)}) — a cache hit "
                "always leaves at least the final position to prefill")
        if self.c == 1:
            return self.prefill_chunk(slot, tokens[start:], start)
        if start:
            raise RuntimeError(
                "suffix prefill needs the chunked (offset) path; a c > 1 "
                "backend prefills whole")
        padded, last = self._pad_prompt(tokens)
        S = padded.shape[1]
        with torch.inference_mode():
            logits, small = self._cp_prefill(padded, last, S)
            seed_cp_pages(*self._page_stages(small),
                          self._tensor(self.block_tables[slot]), S,
                          self.page_size)
        return self._token_of(logits)

    def finish_prefill(self, slot: int) -> None:
        """Mark a fully prefilled slot decode-eligible."""
        self._require_paged()
        self._decodable.add(slot)

    def _extend_decoding(self, pos, lo: int, hi: int) -> None:
        """Extend the pages of the decoding slots in [lo, hi) to cover
        their incoming position (each claim under ``_claim_guard``), then
        replay the copy-on-writes."""
        for slot in sorted(self._decodable):
            if lo <= slot < hi:
                self._claim_guard(
                    lambda s=slot: self.pool.extend(self._owner(s),
                                                    int(pos[s]) + 1))
                self._set_table(slot)
        self._apply_cow()

    def _paged_decode(self, tokens, pos) -> np.ndarray:
        """Extend the decoding slots' pages to cover the incoming position,
        then one paged pass (S = 1) over the whole slot batch; every other
        slot's table row points at scratch page 0."""
        pos = np.asarray(pos)
        self._extend_decoding(pos, 0, self.num_slots)
        bt = self.block_tables.copy()
        for slot in range(self.num_slots):
            if slot not in self._decodable:
                bt[slot] = 0                # scratch page (kvpool.py)
        return self._paged_tokens(np.asarray(tokens, np.int32)[:, None],
                                  np.asarray(pos, np.int32), bt)

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
                # no-op for a never-admitted slot
                self.pool.free(self._owner(s))
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

    def _page_stages(self, small):
        """(this process's page pools, a CP pass's caches ``small``), each
        [stage][rank], for ``seed_cp_pages``."""
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

    def _token_of(self, logits) -> int:
        """The greedy token of a batch-1 prefill's logits [1, v]."""
        return int(torch.argmax(logits[0]))

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
        return self._token_of(logits)

    def _paged_tokens(self, tokens, pos, bt) -> np.ndarray:
        """The greedy tokens [B] int32 of one paged pass's last
        position."""
        return np.asarray(np.argmax(self._paged_call(tokens, pos, bt), -1),
                          np.int32)

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
                 prefix_cache: bool = False, pool: Optional[KVPool] = None,
                 owner_base: int = 0, device=None):
        self.device = resolve_device(device)
        super().__init__(cfg, num_slots, max_len, t=1, p=1, paged=paged,
                         page_size=page_size, num_pages=num_pages,
                         prefix_cache=prefix_cache, pool=pool,
                         owner_base=owner_base)
        check_params_device(params, self.device)
        self.model = get_model(cfg)
        self.params = params
        self._init_device_cache()

    def _write_slot(self, small, slot: int) -> None:
        # every cache family keeps the batch on axis 1 of each leaf
        for key, val in small.items():
            self.cache[key][:, slot] = val[:, 0]

    def _page_pools(self):
        return [(0, self.cache)]


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
    the CUDA card.  ``place`` puts the t·c ranks on t·c processes (the
    rank's TP and CP ``DistGroup``s, its shard and its cache only; its
    card is ``place.device``)."""

    def __init__(self, cfg: ModelConfig, params, num_slots: int,
                 max_len: int = 256, t: int = 2, paged: bool = False,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 c: int = 1, quant_collectives: Optional[str] = None,
                 quant_chunk: int = DEFAULT_QUANT_CHUNK,
                 prefix_cache: bool = False, pool: Optional[KVPool] = None,
                 owner_base: int = 0, device=None, place=None):
        self.device = _device_of(place, device)
        super().__init__(cfg, num_slots, max_len, t=t, p=1, paged=paged,
                         page_size=page_size, num_pages=num_pages, c=c,
                         quant_collectives=quant_collectives,
                         quant_chunk=quant_chunk, prefix_cache=prefix_cache,
                         pool=pool, owner_base=owner_base, place=place)
        check_params_device(params, self.device)
        self.model = TPModel(cfg, t, quant=self.quant,
                             quant_chunk=self.quant_chunk, c=c,
                             group=place and place.group,
                             cp_group=place and place.cp_group)
        self.params = shard_params(cfg, params, t,
                                   self.model.group.local_ranks)
        self._init_device_cache()

    def _write_slot(self, small, slot: int) -> None:
        for rank, part in zip(self.cache, small):
            for key in ("k", "v"):
                rank[key][:, slot] = part[key][:, 0]

    def _cp_prefill(self, padded, last: int, cache_w: int):
        return self.model.cp_prefill(self.params, padded, last, cache_w)

    def _page_stages(self, small):
        return [self.cache], [small]

    def _page_pools(self):
        return [(0, rank) for rank in self.cache]


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
    ``device`` defaults to the CUDA card.  ``place`` puts the t·c·p ranks
    on as many processes: each keeps its own stage's shard and caches
    (``self.staged``, ``self.caches`` and ``gcaches[g]`` hold None for the
    other stages), runs only its stage's instructions, and takes each
    round's tokens from the last stage's broadcast; at ``inflight`` > 1
    the stages' processes then work on different groups at once."""

    def __init__(self, cfg: ModelConfig, params, num_slots: int,
                 max_len: int = 256, t: int = 1, p: int = 2,
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None, c: int = 1,
                 inflight: int = 1,
                 quant_collectives: Optional[str] = None,
                 quant_chunk: int = DEFAULT_QUANT_CHUNK,
                 prefix_cache: bool = False, pool: Optional[KVPool] = None,
                 owner_base: int = 0, device=None, place=None):
        if p < 2:
            raise ValueError(f"pp backend needs p >= 2, got p={p}")
        self.device = _device_of(place, device)
        super().__init__(cfg, num_slots, max_len, t=t, p=p, paged=paged,
                         page_size=page_size, num_pages=num_pages, c=c,
                         quant_collectives=quant_collectives,
                         quant_chunk=quant_chunk, prefix_cache=prefix_cache,
                         pool=pool, owner_base=owner_base, place=place)
        if inflight < 1 or num_slots % inflight:
            raise ValueError(
                f"inflight must divide num_slots: got inflight={inflight}, "
                f"num_slots={num_slots}")
        self.inflight = int(inflight)
        self.group_size = self.num_slots // self.inflight
        self.engine = PipelineEngine(
            cfg, t=t, p=p, c=c, quant_collectives=self.quant,
            quant_chunk=self.quant_chunk, device=self.device, place=place)
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

    def _first_token(self, logits, batch: int) -> np.ndarray:
        """The greedy tokens [batch] of the last stage's logits, on every
        rank (``PipelineEngine.next_token``)."""
        return self.engine.next_token(logits, batch).cpu().numpy()

    def _token_of(self, logits) -> int:
        return int(self._first_token(logits, 1)[0])

    def _cp_prefill(self, padded, last: int, cache_w: int):
        return self.engine.prefill_with_cache(self.staged, padded, cache_w,
                                              last)

    def _page_stages(self, small):
        return self.caches, small

    def _page_pools(self):
        # stage s holds layers [lo, hi) of every page, split over its ranks
        return [(lo, rank) for stage, (lo, _) in
                zip(self.caches, self.engine.ranges) if stage is not None
                for rank in stage]

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
            if stage is None:
                continue
            for rank, piece in zip(stage, part):
                for key in ("k", "v"):
                    rank[key][:, row] = piece[key][:, 0]
        return self._token_of(logits)

    def _paged_pass(self, tokens, pos, bt):
        """The last stage's logits [B, v] of one paged pass (None on a
        rank of another stage)."""
        phase = "decode" if np.shape(tokens)[1] == 1 else "prefill"
        logits, self.caches = self.engine.paged_pass(
            self.staged, self.caches, self._tensor(tokens), self._tensor(pos),
            self._tensor(bt), phase)
        return logits

    @torch.inference_mode()
    def _paged_call(self, tokens, pos, bt) -> np.ndarray:
        return self._paged_pass(tokens, pos, bt).float().cpu().numpy()

    @torch.inference_mode()
    def _paged_tokens(self, tokens, pos, bt) -> np.ndarray:
        return self._first_token(self._paged_pass(tokens, pos, bt),
                                 len(tokens))

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
            out[lo:lo + G] = self._first_token(logits, G)
        return out

    # -- the instruction queue's surface (runtime/schedule.py) --------------
    def make_queue(self):
        """The dynamic per-stage instruction queue at depth ``inflight``."""
        return DynamicPPQueue(self)

    @torch.inference_mode()
    def start_round(self, g: int, tokens, pos):
        """(stage-0 input, the group's positions, block tables or None) of
        one decode round of group ``g``.  Paged, the group's decoding slots'
        pages are extended here, before any instruction issues, so a
        MemoryError surfaces with the round not in flight and the
        scheduler can preempt; the other rows of the group point at
        scratch page 0."""
        G = self.group_size
        lo = g * G
        toks = np.asarray(tokens, np.int32)[lo:lo + G]
        pos_g = self._tensor(np.asarray(pos)[lo:lo + G])
        if not self.paged:
            return self.engine.feed_tokens(toks), pos_g, None
        self._extend_decoding(np.asarray(pos), lo, lo + G)
        bt = self.block_tables[lo:lo + G].copy()
        for i, slot in enumerate(range(lo, lo + G)):
            if slot not in self._decodable:
                bt[i] = 0                   # scratch page (kvpool.py)
        return self.engine.feed_tokens(toks[:, None]), pos_g, self._tensor(bt)

    @torch.inference_mode()
    def run_stage(self, g: int, s: int, x, pos, bt=None):
        """One ``StageForward``: stage s against group g's caches
        (contiguous) or the stage's page pool (paged); nothing, on real
        ranks, for a stage another process runs."""
        if self.staged[s] is None:
            return None
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
        return self.engine.send_boundary(out, s, (self.group_size, 1),
                                         phase="decode")

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
                 prefix_cache: bool = False,
                 pool: Optional[KVPool] = None, owner_base: int = 0,
                 device=None, place=None) -> DecodeBackend:
    """Backend factory keyed by engine kind: "gspmd" is the single-device
    engine (t = p = 1), "tp" the explicit TP engine on t >= 2 virtual
    ranks or c >= 2 CP workers (t = 1, c > 1: the pure-CP layout), "pp"
    the pipeline engine on p >= 2 virtual stages (hybrid at t >= 2); c > 1
    adds context-parallel prefill to the explicit engines.
    ``inflight`` > 1 splits the slots into microbatch groups on the pp
    backend's dynamic queue; the fused engines have no pipeline bubble to
    fill and reject it.  ``quant_collectives`` needs the explicit engines'
    hand-placed all-reduces; the single-device engine rejects it.
    ``prefix_cache`` attaches a ``PrefixIndex`` (paged, c = 1);
    ``pool`` / ``owner_base`` share another backend's ``KVPool`` under a
    disjoint owner range (the disaggregated prefill and decode pools).
    ``place`` (``core.comm.dist_groups(t, p, c=c)``) runs the tp or pp
    backend on real ranks, one process each."""
    kw = dict(paged=paged, page_size=page_size, num_pages=num_pages,
              prefix_cache=prefix_cache, pool=pool, owner_base=owner_base,
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
        if place is not None:
            raise ValueError("the gspmd backend is one device: it takes no "
                             "ranks")
        return ModelBackend(cfg, params, num_slots, max_len, **kw)
    qkw = dict(quant_collectives=quant_collectives, quant_chunk=quant_chunk)
    if kind == "tp":
        if t < 2 and c < 2:
            raise ValueError(
                f"tp backend needs t >= 2 or c >= 2, got t={t} c={c}")
        return TPBackend(cfg, params, num_slots, max_len, t=t, c=c, **qkw,
                         place=place, **kw)
    if kind == "pp":
        return PPBackend(cfg, params, num_slots, max_len, t=t, p=p, c=c,
                         inflight=inflight, place=place, **qkw, **kw)
    raise ValueError(f"unknown backend kind: {kind!r}")
