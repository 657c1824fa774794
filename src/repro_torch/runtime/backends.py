"""DecodeBackend: the slot-based decode protocol the scheduler drives.

Counterpart of ``repro.runtime.backends`` for the single-device engine
(``make_backend("gspmd", ...)`` -> ``ModelBackend``).  The explicit TP and
PP backends are ROADMAP items A3/A4 and A5.

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
"""
from __future__ import annotations

from typing import List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.core.commodel import CommOp, chunked_prefill_ops, \
    comm_ops_for
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import get_model, resolve_device
from repro_torch.runtime.engine import check_params_device
from repro_torch.runtime.kvpool import KVPool
from repro_torch.runtime.schedule import FusedQueue


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


class _BackendBase:
    """Slot and page bookkeeping + predicted per-step communication."""

    def __init__(self, cfg: ModelConfig, num_slots: int, max_len: int,
                 t: int, p: int, paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None):
        if not cfg.is_decoder:
            raise ValueError(f"{cfg.name} is encoder-only: no decode")
        self.cfg = cfg
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.t, self.c, self.p = int(t), 1, int(p)
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

    def can_admit(self, prompt_len: int, max_new_tokens: int = 1) -> bool:
        """True when the pool covers this request's worst case (prompt +
        max_new_tokens - 1 positions) on top of every live request's
        committed growth — conservative admission: a decode step can never
        run out of pages."""
        self._require_paged()
        committed = sum(
            max(0, self._worst.get(o, 0) - len(self.pool.block_table(o)))
            for o in self.pool.owners() if 0 <= o < self.num_slots)
        need = self._pages_for(max(prompt_len,
                                   prompt_len + max_new_tokens - 1))
        return self.pool.free_pages - committed >= need

    def begin_prefill(self, slot: int, prompt_len: int,
                      max_new_tokens: int = 1) -> None:
        """Allocate the slot's pages for a new prompt and commit its
        worst-case decode growth (see ``can_admit``)."""
        self._require_paged()
        self.pool.free(slot)               # the slot may be reused
        self._decodable.discard(slot)
        self.pool.allocate(slot, prompt_len)
        self._worst[slot] = self._pages_for(
            max(prompt_len, prompt_len + max_new_tokens - 1))
        self._set_table(slot)

    def prefill_chunk(self, slot: int, tokens, start: int) -> int:
        """One chunked-prefill pass for ``tokens`` at positions
        start..start+S-1; returns the greedy token of its last position."""
        self._require_paged()
        chunk = np.asarray(tokens, np.int32)[None, :]
        pos = np.asarray([start], np.int32)
        bt = self.block_tables[slot:slot + 1]
        logits = self._paged_call(chunk, pos, bt)
        return int(np.argmax(logits[0]))

    def prefill_whole(self, slot: int, tokens) -> int:
        """Prefill a whole prompt into the slot's allocated pages as one
        chunk; returns the first greedy token."""
        return self.prefill_chunk(slot, np.asarray(tokens).reshape(-1), 0)

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

    def _paged_call(self, tokens, pos, bt) -> np.ndarray:
        """(logits [B, v]) of one paged pass; updates the cache in place."""
        raise NotImplementedError

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
        decode rows of ``comm_ops_for`` at s_d = 2."""
        ops = comm_ops_for(self.cfg, 1, 2, self.t, self.p, c=self.c,
                           batch=batch, b=self._itemsize(),
                           gather_mode="allgather")
        return [o for o in ops if o.phase == "decode"]

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

    def _prefill_slot(self, prompt, slot: int) -> int:
        raise NotImplementedError


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
        if self.paged:
            self.cache = self.model.init_paged_cache(
                self.pool.num_pages, self.page_size, self.device)
        else:
            self.cache = self.model.init_cache(num_slots, max_len,
                                               self.device)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    @torch.inference_mode()
    def _prefill_slot(self, prompt, slot: int) -> int:
        logits, small, _ = self.model.prefill(
            self.params, self._tensor(prompt)[None, :], self.max_len)
        for key in ("k", "v"):
            self.cache[key][:, slot] = small[key][:, 0]
        return int(torch.argmax(logits[0]))

    @torch.inference_mode()
    def _paged_call(self, tokens, pos, bt) -> np.ndarray:
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


def make_backend(kind: str, cfg: ModelConfig, params, num_slots: int,
                 max_len: int = 256, t: int = 1, p: int = 1,
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 device=None) -> DecodeBackend:
    """Backend factory keyed by engine kind.  "gspmd" is the single-device
    engine (t = p = 1); "tp" and "pp" wait for the explicit engines."""
    if kind == "gspmd":
        if t != 1 or p != 1:
            raise ValueError(f"the gspmd backend is one device: got t={t} "
                             f"p={p}")
        return ModelBackend(cfg, params, num_slots, max_len, paged=paged,
                            page_size=page_size, num_pages=num_pages,
                            device=device)
    if kind == "tp":
        raise NotImplementedError(
            "the explicit TP engine and its backends are ROADMAP items "
            "A3/A4")
    if kind == "pp":
        raise NotImplementedError(
            "the pipeline engine and its backends are ROADMAP item A5")
    raise ValueError(f"unknown backend kind: {kind!r}")
