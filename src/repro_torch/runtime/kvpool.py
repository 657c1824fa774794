"""Paged KV-cache block allocator (DESIGN.md §8).

The slot backends used to pin every request to a contiguous ``max_len`` KV
row — long-context traces either OOM the slot pool or waste most of it.  The
pool instead carves the cache into fixed-size *pages* of ``page_size`` token
positions each and hands requests pages on demand: a request's KV lives at
the physical pages named by its *block table*, in logical order, and logical
position ``q`` maps to physical row ``table[q // page_size] * page_size +
q % page_size``.

This module is the host-side bookkeeping only — pure Python over integers,
no jax.  The device side (``models/layers.paged_gather`` and the engines'
paged steps) consumes the block tables as [B, pages_per_seq] int32 arrays.

Invariants (property-tested in tests/test_kvpool.py):

  * a free page is never in any live block table, and a live page is owned
    by exactly one owner unless it was explicitly shared (``fork`` /
    ``adopt``) — pages are ref-counted, so shared prefixes free correctly;
  * freed pages return to the free list and are reused (LIFO — the hottest
    page comes back first);
  * ``stats()`` always accounts for every page:
    ``free_pages + allocated_pages == num_pages`` (page 0 is a reserved
    scratch page, counted as allocated forever), and a page shared by k
    owners counts ONCE — physically — in every token column.

Copy-on-write (DESIGN.md §13).  ``extend`` growing into a *shared* partial
tail page no longer refuses: it claims a private page, swaps it into the
owner's table, decrefs the original, and records a :class:`CowEvent` naming
(src, dst, committed rows).  The pool is host bookkeeping — it cannot touch
device memory — so the backend that owns the device page pools drains
``take_cow_events()`` after every ``extend`` and replays each event as a
device row copy *before* the pass that writes the new positions.  The claim
happens atomically with the ordinary growth claim: a pool-oom mid-COW
raises ``MemoryError`` with the owner's table, lengths, refcounts and the
event log all untouched (no half-copied page can leak).

Page 0 is **reserved**: it is never handed out, and backends point the block
tables of inactive slots at it so a fused decode step's garbage writes for
free slots land in scratch instead of corrupting a live page (the paged
counterpart of "free slots compute garbage the scheduler ignores",
DESIGN.md §7).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

SCRATCH_PAGE = 0


@dataclasses.dataclass(frozen=True)
class CowEvent:
    """One copy-on-write the pool performed in bookkeeping and the backend
    must replay on the device pools: copy the ``rows`` committed positions
    of physical page ``src`` into the freshly claimed page ``dst``."""

    src: int
    dst: int
    rows: int


@dataclasses.dataclass(frozen=True)
class PoolStats:
    """Occupancy + fragmentation snapshot; fields sum to the pool size.

    Every token column is *physical*: a page shared by k owners (``fork`` /
    ``adopt``) contributes its committed rows ONCE — the per-owner sum the
    pre-COW pool reported double-counted every ref-shared page, pushing
    utilization past 1.0 under prefix sharing.  ``shared_pages`` counts the
    pages currently held by more than one owner; ``cow_copies`` is the
    pool-lifetime count of copy-on-write page splits."""

    num_pages: int
    page_size: int
    free_pages: int
    allocated_pages: int          # includes the reserved scratch page
    used_tokens: int              # PHYSICAL token positions occupied
    internal_frag_tokens: int     # allocated-but-unused positions (physical)
    shared_pages: int = 0         # pages with refcount > 1 right now
    cow_copies: int = 0           # lifetime copy-on-write splits

    @property
    def capacity_tokens(self) -> int:
        return self.num_pages * self.page_size

    @property
    def utilization(self) -> float:
        """Occupied fraction of the *allocated* (non-scratch) capacity."""
        alloc = (self.allocated_pages - 1) * self.page_size
        return self.used_tokens / alloc if alloc else 0.0


class KVPool:
    """Fixed-size-page KV allocator with per-owner block tables.

    ``allocate(owner, num_tokens)`` claims pages for a new sequence,
    ``extend(owner, new_len)`` grows it (decode crossing a page boundary;
    copy-on-write when the partial tail is shared), ``free(owner)`` releases
    it, ``fork(owner, new_owner, length=...)`` shares a prefix of the
    current pages (both owners read the same prefix; the pages free only
    when the last owner releases them), ``adopt(owner, pages, num_tokens)``
    builds an owner from an explicit list of live pages — the prefix
    index's cache-hit handoff (runtime/prefix_index.py).
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved scratch)")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list, excluding the reserved scratch page 0
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refcount: Dict[int, int] = {}      # physical page -> owners
        self._tables: Dict[int, List[int]] = {}  # owner -> logical->physical
        self._lengths: Dict[int, int] = {}       # owner -> tokens occupied
        self._cow_events: List[CowEvent] = []    # pending device-row copies
        self.cow_copies = 0                      # lifetime COW splits

    # ------------------------------------------------------------- helpers
    def _pages_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)      # ceil div

    def _claim(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"pool exhausted: need {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for pg in pages:
            assert pg not in self._refcount, f"page {pg} double-assigned"
            self._refcount[pg] = 1
        return pages

    # ------------------------------------------------------------ interface
    def allocate(self, owner: int, num_tokens: int) -> List[int]:
        """Claim pages covering ``num_tokens`` positions for a new owner;
        returns the block table (logical order)."""
        if owner in self._tables:
            raise KeyError(f"owner {owner} already holds an allocation")
        if num_tokens < 1:
            raise ValueError(f"num_tokens must be >= 1, got {num_tokens}")
        self._tables[owner] = self._claim(self._pages_for(num_tokens))
        self._lengths[owner] = num_tokens
        return list(self._tables[owner])

    def extend(self, owner: int, new_len: int) -> List[int]:
        """Grow an allocation to cover ``new_len`` positions (no-op when the
        current last page still has room); returns the updated table.

        Growing into a *shared* partial tail page copy-on-writes it
        (DESIGN.md §13): a private page is claimed, swapped into this
        owner's table, and the original decref'd — the sibling owners keep
        reading the untouched original.  The split is recorded as a
        :class:`CowEvent` for the backend to replay as a device row copy
        (``take_cow_events``).  All pages — the COW copy and any growth —
        are claimed in ONE atomic step, so a pool-oom raises ``MemoryError``
        before any state mutates.  A page-aligned shared prefix grows
        without copying: new positions land only on freshly-claimed
        exclusive pages.
        """
        table = self._tables[owner]
        cur = self._lengths[owner]
        if new_len < cur:
            raise ValueError(
                f"extend shrinks owner {owner}: {new_len} < {cur}")
        cow = new_len > cur and cur % self.page_size != 0 and \
            self._refcount[table[-1]] > 1
        need = self._pages_for(new_len) - len(table)
        pages = self._claim(need + (1 if cow else 0))
        if cow:
            src, dst = table[-1], pages[0]
            committed = cur - (len(table) - 1) * self.page_size
            table[-1] = dst
            self._refcount[src] -= 1     # shared: never hits 0 here
            self.cow_copies += 1
            self._cow_events.append(CowEvent(src, dst, committed))
            pages = pages[1:]
        table.extend(pages)
        self._lengths[owner] = new_len
        return list(table)

    def take_cow_events(self) -> List[CowEvent]:
        """Drain the pending copy-on-write events.  The device-side owner
        of the page pools MUST replay each as a row copy src→dst before the
        next pass that writes (or reads) the new private page."""
        events, self._cow_events = self._cow_events, []
        return events

    def fork(self, owner: int, new_owner: int,
             length: int = None) -> List[int]:
        """Share a prefix of ``owner``'s pages with ``new_owner``: both
        tables name the same physical pages, refcounts bumped.  ``length``
        (tokens; default: the owner's full length) shares only the pages
        covering that prefix — the cache-hit fork, where the new request
        adopts the cached pages and prefills just its novel suffix."""
        if new_owner in self._tables:
            raise KeyError(f"owner {new_owner} already holds an allocation")
        length = self._lengths[owner] if length is None else int(length)
        if not 1 <= length <= self._lengths[owner]:
            raise ValueError(
                f"fork length {length} outside (0, {self._lengths[owner]}]")
        table = self._tables[owner][:self._pages_for(length)]
        for pg in table:
            self._refcount[pg] += 1
        self._tables[new_owner] = list(table)
        self._lengths[new_owner] = length
        return list(table)

    def adopt(self, owner: int, pages: List[int],
              num_tokens: int) -> List[int]:
        """Build ``owner``'s allocation from an explicit list of LIVE pages
        (each refcount-bumped) covering ``num_tokens`` positions — how a
        cache hit assembled from per-block prefix-index entries lands in a
        slot, and the KV-handoff unit disaggregated prefill will ship."""
        if owner in self._tables:
            raise KeyError(f"owner {owner} already holds an allocation")
        pages = [int(pg) for pg in pages]
        if not pages:
            raise ValueError("adopt needs at least one page")
        if not (len(pages) - 1) * self.page_size < num_tokens \
                <= len(pages) * self.page_size:
            raise ValueError(
                f"{num_tokens} tokens do not fit exactly {len(pages)} pages "
                f"of {self.page_size}")
        for pg in pages:
            if pg not in self._refcount:
                raise ValueError(f"page {pg} is not live — cannot adopt")
        for pg in pages:
            self._refcount[pg] += 1
        self._tables[owner] = list(pages)
        self._lengths[owner] = int(num_tokens)
        return list(pages)

    def free(self, owner: int) -> None:
        """Release an owner; pages whose refcount hits zero rejoin the free
        list (LIFO).  Freeing an unknown owner is a no-op — the scheduler
        frees slots it may never have admitted into."""
        table = self._tables.pop(owner, None)
        if table is None:
            return
        del self._lengths[owner]
        for pg in reversed(table):
            self._refcount[pg] -= 1
            if self._refcount[pg] == 0:
                del self._refcount[pg]
                self._free.append(pg)

    # --------------------------------------------------------- introspection
    def block_table(self, owner: int) -> List[int]:
        return list(self._tables[owner])

    def owners(self) -> List[int]:
        return list(self._tables)

    def length(self, owner: int) -> int:
        return self._lengths[owner]

    def page_refcount(self, page: int) -> int:
        """Owners currently holding physical ``page`` (0 when free)."""
        return self._refcount.get(page, 0)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def stats(self) -> PoolStats:
        # physical occupancy: each page's committed rows counted ONCE —
        # the deepest committed row any owner has in it (owners sharing a
        # page agree on its content; they can only differ in how far their
        # own length reaches into it)
        rows: Dict[int, int] = {}
        for o, t in self._tables.items():
            ln = self._lengths[o]
            for i, pg in enumerate(t):
                r = min(self.page_size, ln - i * self.page_size)
                if r > rows.get(pg, 0):
                    rows[pg] = r
        used = sum(rows.values())
        allocated = self.num_pages - len(self._free)
        return PoolStats(
            num_pages=self.num_pages, page_size=self.page_size,
            free_pages=len(self._free),
            allocated_pages=allocated,
            used_tokens=used,
            internal_frag_tokens=(allocated - 1) * self.page_size - used,
            shared_pages=sum(1 for n in self._refcount.values() if n > 1),
            cow_copies=self.cow_copies)
