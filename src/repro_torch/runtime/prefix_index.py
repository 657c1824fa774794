"""Cross-request prefix index: radix/hash lookup over prompt token blocks
(DESIGN.md §13).

Production traffic is thousands of users sharing a handful of system
prompts — the paper's TTFT analysis says prefill (and every collective
inside it) dominates short interactive requests, yet that prefill is
recomputed per request for tokens the KV pool already holds.  This module
is the vLLM-style fix: an index over *page-granular* blocks of prompt
tokens, so ``Scheduler`` can detect the longest cached prefix of a new
request, ``adopt`` its pages, and run chunked prefill only over the novel
suffix.

Keying.  Block ``i`` of a prompt is tokens ``[i·ps, (i+1)·ps)``; its key is
the raw bytes of the prompt's first ``(i+1)·ps`` tokens — a chain key, so a
block entry matches only when every block before it matches too (the radix
property, with exact-bytes keys instead of hashes: a hash collision here
would silently serve another prompt's KV, which is a token-corruption bug,
not a cache miss).  Only FULL blocks are indexed: a partial tail page's
rows keep being rewritten by decode, so its content is not a function of
the prompt alone.

Ref-counting.  Each entry owns its single page through a dedicated pool
owner (negative ids — slot owners are >= 0) via ``KVPool.adopt``, so the
ordinary refcount machinery keeps cached pages alive after the request
that wrote them frees its slot, and ``stats()`` stays physically honest.
A cache hit re-adopts the matched entries' pages into the new request's
slot; a hit that covers the whole prompt is capped at ``prompt_len - 1``
(the last position must be prefilled to produce the first token), which
shares the final page *partially* — the first write into it triggers the
pool's copy-on-write.

Eviction.  Entries are LRU (refreshed on lookup hit and on insert).  Under
pool pressure the backend calls ``evict_one``/``evict_for`` to pop LRU
entries until enough pages return to the free list; an entry whose page
other owners still hold frees nothing immediately (the page returns when
the last owner does) but stops pinning it.  ``reclaimable_pages`` — the
entries whose page would free *right now* — joins the admission gate's
free-page arithmetic, so a pool full of cold cache is never mistaken for a
full pool.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import List, Optional

import numpy as np

from repro_torch.runtime.kvpool import KVPool


@dataclasses.dataclass
class PrefixHit:
    """Longest cached prefix of a prompt: the physical pages to adopt and
    the token positions they cover (capped below the full prompt so the
    final position is always prefilled)."""

    length: int                  # tokens covered (0 = miss)
    pages: List[int]             # physical pages, logical order

    @property
    def hit(self) -> bool:
        return self.length > 0


@dataclasses.dataclass
class _Entry:
    owner: int                   # index-held pool owner (negative)
    page: int                    # the single physical page this entry pins
    blocks: int                  # chain depth: this is block `blocks - 1`


class PrefixIndex:
    """Page-granular prefix cache over a :class:`KVPool`."""

    def __init__(self, pool: KVPool, max_entries: Optional[int] = None):
        self.pool = pool
        self.page_size = pool.page_size
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._next_owner = -1    # index owners are negative; slots are >= 0
        self.hits = 0            # lookups that matched >= 1 block
        self.misses = 0
        self.evictions = 0       # entries evicted (pressure or capacity)

    # ------------------------------------------------------------- keying
    def _key(self, tokens: np.ndarray, blocks: int) -> bytes:
        return np.ascontiguousarray(
            tokens[:blocks * self.page_size], np.int32).tobytes()

    # ------------------------------------------------------------ interface
    def lookup(self, tokens) -> PrefixHit:
        """Longest cached prefix of ``tokens``, capped at ``len(tokens)-1``
        so at least one position remains for the suffix prefill (the hit
        request still needs the final position's logits).  Matched entries
        are LRU-refreshed.  The returned pages are NOT yet pinned for the
        caller — adopt them (``KVPool.adopt``) before anything can evict."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        pages: List[int] = []
        blocks = 0
        while blocks < len(tokens) // self.page_size:
            e = self._entries.get(self._key(tokens, blocks + 1))
            if e is None:
                break
            pages.append(e.page)
            blocks += 1
        if blocks == 0:
            self.misses += 1
            return PrefixHit(0, [])
        for i in range(blocks):
            self._entries.move_to_end(self._key(tokens, i + 1))
        self.hits += 1
        # a fully-covered prompt keeps its final position for the suffix
        # prefill; the shortened length still spans the same pages, so the
        # last one is shared PARTIALLY and the first write COWs it
        length = min(blocks * self.page_size, len(tokens) - 1)
        return PrefixHit(length, pages)

    def insert(self, tokens, pages: List[int]) -> int:
        """Index every full block of ``tokens`` whose KV lives in
        ``pages`` (the owning slot's block table, logical order).  Each new
        entry pins its page through a fresh index owner; blocks already
        present are only LRU-refreshed — idempotent, so re-inserting after
        a recompute or a cache-hit admission is free.  Returns the number
        of NEW entries created."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        full = len(tokens) // self.page_size
        created = 0
        for i in range(min(full, len(pages))):
            key = self._key(tokens, i + 1)
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            owner = self._next_owner
            self._next_owner -= 1
            self.pool.adopt(owner, [pages[i]], self.page_size)
            self._entries[key] = _Entry(owner, pages[i], i + 1)
            created += 1
        while self.max_entries is not None \
                and len(self._entries) > self.max_entries:
            self.evict_one()
        return created

    # ------------------------------------------------------------- eviction
    def evict_one(self) -> bool:
        """Drop the LRU entry (False when the index is empty).  The page
        returns to the free list only if no slot (or deeper entry) still
        holds it — either way the index stops pinning it."""
        if not self._entries:
            return False
        _, e = self._entries.popitem(last=False)
        self.pool.free(e.owner)
        self.evictions += 1
        return True

    def evict_for(self, pages_needed: int) -> int:
        """Evict LRU entries until ``pages_needed`` pages are free in the
        pool (or the index is empty); returns entries evicted."""
        n = 0
        while self.pool.free_pages < pages_needed and self.evict_one():
            n += 1
        return n

    def clear(self) -> int:
        """Evict everything — the drain the zero-leak CI gate exercises."""
        n = 0
        while self.evict_one():
            n += 1
        return n

    # --------------------------------------------------------- introspection
    def reclaimable_pages(self) -> int:
        """Pages that would return to the free list if the index dropped
        every entry right now — entries whose page no one else holds."""
        return sum(1 for e in self._entries.values()
                   if self.pool.page_refcount(e.page) == 1)

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "reclaimable_pages": self.reclaimable_pages()}
