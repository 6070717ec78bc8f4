"""Host-side page allocator + block tables for the paged KV cache (port of
``repro/serve/paging/allocator.py``; pure Python, copied — the port imports
nothing of the reference).

Pure bookkeeping: a free list of fixed-size token pages over one
physical pool, per-slot block tables (logical block j -> physical page id),
reservation-based admission accounting, and copy-on-retire compaction
planning.  The tensor half — the (repeats, P, page, kv, hd) device pools and
the gather/scatter decode — lives in ``repro_torch.serve.paging.manager`` and
``repro_torch.models.attention``.

Design points:

  * **Sentinel page 0.**  Physical page 0 is never allocated; unassigned
    block-table entries point at it.  Gathers through those entries read
    arbitrary bytes that the decode mask zeroes exactly (probability mass
    underflows to 0.0 at NEG_INF), so a partially-filled table is always
    safe to hand to the kernel.
  * **Reservation accounting (OOM-safe admission).**  ``reserve`` charges a
    request's worst case — ceil((prompt + max_new - 1) / page) pages — before
    its slot is admitted; physical pages are drawn lazily as tokens are
    written (``ensure``), but never beyond the reservation, so a mid-decode
    allocation can never fail.  When a reservation does not fit, admission
    is deferred (the service keeps the request queued) and ``submit`` raises
    ``Backpressure`` once the queue itself fills — requests shed, never OOM.
  * **Refcounted sharing (prefix cache).**  A physical page may be mapped by
    several block tables at once (shared prefix pages) and by the radix cache
    itself; ``retain``/``release_page`` count the owners and a page returns
    to the free list only at refcount 0.  Shared pages bound via
    ``bind_shared`` are NOT charged to the slot's reservation — only the
    unshared tail is — which is exactly why warm-prefix admission stops
    over-reserving.  ``pin_page`` marks pages an in-flight request depends on
    so eviction can never free them; the admission invariant becomes
    ``reserved_total + pinned_pages <= usable_pages`` (every unpinned
    cache-exclusive page is reclaimable on demand through ``evict_hook``,
    so lazy ``ensure`` stays infallible).
  * **Low-id pressure + compaction.**  The free list is a min-heap, so
    allocation always takes the lowest free id and the in-use *frontier*
    (highest id + 1) stays tight on its own; ``plan_compaction`` additionally
    relocates the highest in-use pages into lower free holes after a retire
    (copy-on-retire), handing back (src, dst) moves for the device-side copy
    and rewriting the block tables to match.  Shared or pinned pages are
    never relocated (the radix cache holds their physical ids).
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Optional, Tuple

SENTINEL = 0


def pages_for(n_tokens: int, page: int) -> int:
    """Pages needed to hold ``n_tokens`` at ``page`` tokens per page."""
    return -(-max(int(n_tokens), 0) // page)


class PageAllocator:
    """Free-list allocator of fixed-size KV pages with per-slot block tables."""

    def __init__(self, total_pages: int, page: int, n_slots: int, blocks_per_slot: int):
        assert total_pages >= 2, "need at least the sentinel plus one usable page"
        assert page >= 1 and n_slots >= 1 and blocks_per_slot >= 1
        self.page = int(page)
        self.total_pages = int(total_pages)
        self.n_slots = int(n_slots)
        self.blocks_per_slot = int(blocks_per_slot)
        self._free: List[int] = list(range(1, total_pages))  # 0 is the sentinel
        heapq.heapify(self._free)
        self._tables: List[List[int]] = [[] for _ in range(n_slots)]
        self._reserved: List[int] = [0] * n_slots
        # leading entries of _tables[slot] that are shared (radix) pages,
        # refcounted rather than charged against the slot's reservation
        self._shared_count: List[int] = [0] * n_slots
        self._refcount: Dict[int, int] = {}  # phys -> owner count (allocated pages)
        self._pins: Dict[int, int] = {}  # phys -> pin count (in-flight dependents)
        # called with the number of pages needed when the free heap runs dry;
        # returns how many it actually freed (radix LRU eviction plugs in here)
        self.evict_hook: Optional[Callable[[int], int]] = None
        self.reserved_total = 0
        self.in_use = 0  # distinct allocated pages
        self.peak_pages = 0  # high-water mark of concurrently allocated pages
        self.alloc_total = 0
        self.compaction_moves = 0

    # -- capacity / admission accounting -------------------------------------

    @property
    def usable_pages(self) -> int:
        """Allocatable pages (total minus the sentinel page 0)."""
        return self.total_pages - 1  # minus the sentinel

    @property
    def pinned_pages(self) -> int:
        """Pages with at least one pin."""
        return len(self._pins)

    @property
    def shared_pages(self) -> int:
        """Pages mapped by two or more owners."""
        return sum(1 for c in self._refcount.values() if c >= 2)

    def free_pages(self) -> int:
        """Pages currently on the free list."""
        return len(self._free)

    def pages_for_tokens(self, n_tokens: int) -> int:
        """Pages needed for ``n_tokens`` at this pool's page size."""
        return pages_for(n_tokens, self.page)

    def refcount(self, phys: int) -> int:
        """Current owner count of a physical page."""
        return self._refcount.get(phys, 0)

    def pin_count(self, phys: int) -> int:
        """Current pin count of a physical page."""
        return self._pins.get(phys, 0)

    def can_reserve(self, n_tokens: int, *, shared_pages: int = 0,
                    new_pins: int = 0) -> bool:
        """Would a reservation for ``n_tokens`` rows fit right now, charging
        only the unshared tail and keeping ``reserved + pinned <= usable``?
        ``new_pins`` counts plan pages not currently pinned by anyone."""
        need = max(self.pages_for_tokens(n_tokens) - int(shared_pages), 0)
        return (self.reserved_total + need + self.pinned_pages + int(new_pins)
                <= self.usable_pages)

    def fits_ever(self, n_tokens: int) -> bool:
        """Could the request be served by an EMPTY pool (submit-time check)?"""
        need = self.pages_for_tokens(n_tokens)
        return need <= min(self.usable_pages, self.blocks_per_slot)

    def reserve(self, slot: int, n_tokens: int, *, shared_pages: int = 0) -> int:
        """Charge the slot's worst-case UNSHARED page need against the pool;
        the caller must have checked ``can_reserve`` (admission is deferred
        otherwise).  ``shared_pages`` prefix pages are refcount-owned via
        ``bind_shared`` instead."""
        need = max(self.pages_for_tokens(n_tokens) - int(shared_pages), 0)
        if self.reserved_total + need + self.pinned_pages > self.usable_pages:
            raise RuntimeError(
                f"page reservation overflow: {need} pages requested, "
                f"{self.usable_pages - self.reserved_total - self.pinned_pages} unreserved"
            )
        assert self._reserved[slot] == 0 and not self._tables[slot], slot
        self._reserved[slot] = need
        self.reserved_total += need
        return need

    # -- refcounts / pins ------------------------------------------------------

    def retain(self, phys: int):
        """Add an owner to an already-allocated page."""
        if phys == SENTINEL or self._refcount.get(phys, 0) < 1:
            raise RuntimeError(f"retain of unallocated page {phys}")
        self._refcount[phys] += 1

    def release_page(self, phys: int) -> bool:
        """Drop one owner; frees the page (returns True) at refcount 0.
        Releasing an unallocated page — a double free — raises."""
        count = self._refcount.get(phys, 0)
        if phys == SENTINEL or count < 1:
            raise RuntimeError(f"double free of page {phys}")
        if count == 1:
            del self._refcount[phys]
            heapq.heappush(self._free, phys)
            self.in_use -= 1
            return True
        self._refcount[phys] = count - 1
        return False

    def pin_page(self, phys: int):
        """Mark a page as depended on by an in-flight request: eviction must
        never free it (the admission check counted it)."""
        if self._refcount.get(phys, 0) < 1:
            raise RuntimeError(f"pin of unallocated page {phys}")
        self._pins[phys] = self._pins.get(phys, 0) + 1

    def unpin_page(self, phys: int):
        """Drop one pin from a page (raises if it is not pinned)."""
        count = self._pins.get(phys, 0)
        if count < 1:
            raise RuntimeError(f"unpin of unpinned page {phys}")
        if count == 1:
            del self._pins[phys]
        else:
            self._pins[phys] = count - 1

    # -- allocation -----------------------------------------------------------

    def table(self, slot: int) -> List[int]:
        """Copy of a slot's block table (physical page per block)."""
        return list(self._tables[slot])

    def shared_count(self, slot: int) -> int:
        """How many of a slot's mapped pages are shared."""
        return self._shared_count[slot]

    def _alloc_page(self) -> int:
        """Pop the lowest free page, evicting unpinned cache pages on demand.
        Never fails under the ``reserved + pinned <= usable`` invariant."""
        if not self._free and self.evict_hook is not None:
            self.evict_hook(1)
        if not self._free:
            raise RuntimeError("page pool exhausted despite reservation accounting")
        phys = heapq.heappop(self._free)
        self._refcount[phys] = 1
        self.in_use += 1
        self.alloc_total += 1
        self.peak_pages = max(self.peak_pages, self.in_use)
        return phys

    def bind_shared(self, slot: int, pages: List[int]):
        """Map already-cached prefix pages into the slot's table (read-only
        sharing): retained, not charged to the reservation.  Must run before
        any ``ensure``/``cow_bind`` growth."""
        tbl = self._tables[slot]
        assert not tbl, f"slot {slot} table must be empty before bind_shared"
        for phys in pages:
            self.retain(phys)
            tbl.append(phys)
        self._shared_count[slot] = len(tbl)

    def cow_bind(self, slot: int, src: int) -> int:
        """Allocate a fresh page for a copy-on-write of shared page ``src``
        and append it to the slot's table (charged to the reservation).  The
        device copy itself is the caller's batched gather/scatter."""
        tbl = self._tables[slot]
        if len(tbl) + 1 - self._shared_count[slot] > self._reserved[slot]:
            raise RuntimeError(
                f"slot {slot} COW exceeds reservation {self._reserved[slot]}"
            )
        dst = self._alloc_page()
        tbl.append(dst)
        return dst

    def ensure(self, slot: int, n_tokens: int) -> List[Tuple[int, int]]:
        """Grow slot's table to cover ``n_tokens`` written rows.  Returns the
        newly bound (logical_block, physical_page) pairs.  Never exceeds the
        slot's reservation (shared prefix blocks are not counted against it),
        so the allocation cannot fail."""
        tbl = self._tables[slot]
        need = self.pages_for_tokens(n_tokens)
        if need - self._shared_count[slot] > self._reserved[slot]:
            raise RuntimeError(
                f"slot {slot} needs {need - self._shared_count[slot]} pages "
                f"> reservation {self._reserved[slot]}"
            )
        added = []
        while len(tbl) < need:
            phys = self._alloc_page()
            added.append((len(tbl), phys))
            tbl.append(phys)
        return added

    def alloc_pinned(self, n: int) -> List[int]:
        """Allocate ``n`` pages OUTSIDE any slot table and pin them — the
        speculative scratch pool.  Pinning charges them against the
        ``reserved + pinned <= usable`` admission invariant permanently, so
        speculation can never OOM an admitted slot: every scratch page was
        subtracted from admission capacity up front."""
        if self.reserved_total + self.pinned_pages + int(n) > self.usable_pages:
            raise RuntimeError(
                f"cannot pin {n} scratch pages: only "
                f"{self.usable_pages - self.reserved_total - self.pinned_pages} "
                "unreserved pages available"
            )
        pages = []
        for _ in range(int(n)):
            phys = self._alloc_page()
            self.pin_page(phys)
            pages.append(phys)
        return pages

    def swap_page(self, slot: int, block: int, new_phys: int) -> int:
        """Swap pinned out-of-table page ``new_phys`` into the slot's table
        at ``block``, returning the displaced page (which inherits the pin —
        the speculative commit: scratch becomes the slot's tail page, the old
        tail page becomes scratch).  Refcounts, the free list, and the total
        pin count are all unchanged, so every admission invariant survives.
        Only exclusive, unpinned table pages may be displaced."""
        tbl = self._tables[slot]
        old = tbl[block]
        if block < self._shared_count[slot]:
            raise RuntimeError(f"swap of shared block {block} in slot {slot}")
        if self._refcount.get(old, 0) != 1 or old in self._pins:
            raise RuntimeError(
                f"swap target page {old} is shared or pinned (slot {slot} block {block})"
            )
        if self._refcount.get(new_phys, 0) != 1 or new_phys not in self._pins:
            raise RuntimeError(f"swap source {new_phys} must be an exclusive pinned page")
        tbl[block] = new_phys
        self.unpin_page(new_phys)
        self.pin_page(old)
        return old

    def release(self, slot: int):
        """Drop the slot's ownership of its pages and return its reservation.
        Shared pages survive under their remaining owners (radix cache or
        other slots); exclusively-owned pages go back to the free list."""
        for phys in self._tables[slot]:
            self.release_page(phys)
        self._tables[slot] = []
        self._shared_count[slot] = 0
        self.reserved_total -= self._reserved[slot]
        self._reserved[slot] = 0

    # -- compaction -----------------------------------------------------------

    def frontier(self) -> int:
        """One past the highest allocated physical page id (the pool's live
        extent; what a shrinkable backing allocation would have to cover)."""
        top = SENTINEL
        for phys in self._refcount:
            top = max(top, phys)
        return top + 1

    def plan_compaction(self, max_moves: int) -> List[Tuple[int, int]]:
        """Relocate up to ``max_moves`` of the highest in-use pages into the
        lowest free holes below them.  Rewrites the block tables and the free
        list; returns the (src, dst) physical moves the device pools must
        apply (``manager.apply_moves``).  No-op when already compact.  Only
        exclusively-owned, unpinned pages move: the radix cache addresses
        shared pages by physical id, so they must stay put."""
        # position index: physical page -> (slot, logical block)
        where: Dict[int, Tuple[int, int]] = {}
        for s, tbl in enumerate(self._tables):
            for j, phys in enumerate(tbl):
                if self._refcount.get(phys, 0) == 1 and phys not in self._pins:
                    where[phys] = (s, j)
        moves: List[Tuple[int, int]] = []
        while len(moves) < max_moves and self._free and where:
            dst = self._free[0]
            src = max(where)
            if dst >= src:
                break  # every free hole is above every movable page: compact
            heapq.heappop(self._free)
            s, j = where.pop(src)
            self._tables[s][j] = dst
            where[dst] = (s, j)
            self._refcount[dst] = self._refcount.pop(src)
            heapq.heappush(self._free, src)
            moves.append((src, dst))
        self.compaction_moves += len(moves)
        return moves

    # -- scrape surface -------------------------------------------------------

    def metrics(self, prefix: str = "pages_") -> Dict[str, float]:
        """Flat gauge dict of pool occupancy/sharing counters."""
        return {
            f"{prefix}total": float(self.usable_pages),
            f"{prefix}in_use": float(self.in_use),
            f"{prefix}reserved": float(self.reserved_total),
            f"{prefix}peak": float(self.peak_pages),
            f"{prefix}frontier": float(self.frontier() - 1),
            f"{prefix}alloc_total": float(self.alloc_total),
            f"{prefix}compaction_moves": float(self.compaction_moves),
            f"{prefix}shared": float(self.shared_pages),
            f"{prefix}pinned": float(self.pinned_pages),
        }
