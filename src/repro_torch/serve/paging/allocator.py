"""Host-side page allocator + block tables for the paged KV cache (port of
``repro/serve/paging/allocator.py``; pure Python, copied — the port imports
nothing of the reference).

  * **Sentinel page 0.**  Physical page 0 is never allocated; unassigned
    block-table entries point at it.  Reads through those entries fall on
    rows the decode mask gives exactly 0 probability mass, so a partially
    filled table is always safe to hand to the kernel.
  * **Reservation accounting (OOM-safe admission).**  ``reserve`` charges a
    request's worst case — ceil((prompt + max_new - 1) / page) pages — before
    its slot is admitted; physical pages are drawn lazily as rows are
    written (``ensure``), never beyond the reservation, so a mid-decode
    allocation cannot fail.  When a reservation does not fit, admission is
    deferred (the service keeps the request queued).
  * **Low-id pressure + compaction.**  The free list is a min-heap, so
    allocation takes the lowest free id; ``plan_compaction`` relocates the
    highest in-use pages into lower free holes after a retire
    (copy-on-retire), rewrites the block tables and hands back the
    (src, dst) moves for the device-side copy.

Page sharing (refcounts, pins, copy-on-write) and the speculative scratch
pages belong to the prefix-cache and speculative-decoding slice.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

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
        self._owner: Dict[int, int] = {}  # allocated phys -> slot
        self.reserved_total = 0
        self.peak_pages = 0  # high-water mark of concurrently allocated pages
        self.alloc_total = 0
        self.compaction_moves = 0

    # -- capacity / admission accounting -------------------------------------

    @property
    def usable_pages(self) -> int:
        """Allocatable pages (total minus the sentinel page 0)."""
        return self.total_pages - 1

    @property
    def in_use(self) -> int:
        """Pages currently allocated."""
        return len(self._owner)

    def free_pages(self) -> int:
        """Pages currently on the free list."""
        return len(self._free)

    def pages_for_tokens(self, n_tokens: int) -> int:
        """Pages needed for ``n_tokens`` at this pool's page size."""
        return pages_for(n_tokens, self.page)

    def can_reserve(self, n_tokens: int) -> bool:
        """Would a reservation for ``n_tokens`` rows fit right now?"""
        return self.reserved_total + self.pages_for_tokens(n_tokens) <= self.usable_pages

    def fits_ever(self, n_tokens: int) -> bool:
        """Could the request be served by an EMPTY pool (submit-time check)?"""
        return self.pages_for_tokens(n_tokens) <= min(self.usable_pages, self.blocks_per_slot)

    def reserve(self, slot: int, n_tokens: int) -> int:
        """Charge the slot's worst-case page need against the pool; the
        caller must have checked ``can_reserve`` (admission is deferred
        otherwise)."""
        need = self.pages_for_tokens(n_tokens)
        if self.reserved_total + need > self.usable_pages:
            raise RuntimeError(
                f"page reservation overflow: {need} pages requested, "
                f"{self.usable_pages - self.reserved_total} unreserved"
            )
        assert self._reserved[slot] == 0 and not self._tables[slot], slot
        self._reserved[slot] = need
        self.reserved_total += need
        return need

    # -- allocation -----------------------------------------------------------

    def table(self, slot: int) -> List[int]:
        """Copy of a slot's block table (physical page per block)."""
        return list(self._tables[slot])

    def _alloc_page(self, slot: int) -> int:
        if not self._free:
            raise RuntimeError("page pool exhausted despite reservation accounting")
        phys = heapq.heappop(self._free)
        self._owner[phys] = slot
        self.alloc_total += 1
        self.peak_pages = max(self.peak_pages, self.in_use)
        return phys

    def ensure(self, slot: int, n_tokens: int) -> List[Tuple[int, int]]:
        """Grow the slot's table to cover ``n_tokens`` written rows.  Returns
        the newly bound (logical_block, physical_page) pairs.  Never exceeds
        the slot's reservation, so the allocation cannot fail."""
        tbl = self._tables[slot]
        need = self.pages_for_tokens(n_tokens)
        if need > self._reserved[slot]:
            raise RuntimeError(f"slot {slot} needs {need} pages > reservation {self._reserved[slot]}")
        added = []
        while len(tbl) < need:
            phys = self._alloc_page(slot)
            added.append((len(tbl), phys))
            tbl.append(phys)
        return added

    def release(self, slot: int):
        """Return the slot's pages to the free list and its reservation to
        the pool."""
        for phys in self._tables[slot]:
            if self._owner.pop(phys, None) != slot:
                raise RuntimeError(f"double free of page {phys}")
            heapq.heappush(self._free, phys)
        self._tables[slot] = []
        self.reserved_total -= self._reserved[slot]
        self._reserved[slot] = 0

    # -- compaction -----------------------------------------------------------

    def frontier(self) -> int:
        """One past the highest allocated physical page id."""
        return max(self._owner, default=SENTINEL) + 1

    def plan_compaction(self, max_moves: int) -> List[Tuple[int, int]]:
        """Relocate up to ``max_moves`` of the highest in-use pages into the
        lowest free holes below them.  Rewrites the block tables and the free
        list; returns the (src, dst) physical moves the device pools must
        apply.  No-op when already compact."""
        where: Dict[int, Tuple[int, int]] = {}
        for s, tbl in enumerate(self._tables):
            for j, phys in enumerate(tbl):
                where[phys] = (s, j)
        moves: List[Tuple[int, int]] = []
        while len(moves) < max_moves and self._free and where:
            dst = self._free[0]
            src = max(where)
            if dst >= src:
                break  # every free hole is above every in-use page: compact
            heapq.heappop(self._free)
            s, j = where.pop(src)
            self._tables[s][j] = dst
            where[dst] = (s, j)
            self._owner[dst] = self._owner.pop(src)
            heapq.heappush(self._free, src)
            moves.append((src, dst))
        self.compaction_moves += len(moves)
        return moves

    # -- scrape surface -------------------------------------------------------

    def metrics(self, prefix: str = "pages_") -> Dict[str, float]:
        """Flat gauge dict of pool occupancy counters."""
        return {
            f"{prefix}total": float(self.usable_pages),
            f"{prefix}in_use": float(self.in_use),
            f"{prefix}reserved": float(self.reserved_total),
            f"{prefix}peak": float(self.peak_pages),
            f"{prefix}frontier": float(self.frontier() - 1),
            f"{prefix}alloc_total": float(self.alloc_total),
            f"{prefix}compaction_moves": float(self.compaction_moves),
        }
