"""PagedKVManager: the bridge between the host-side ``PageAllocator`` and
the device-side page pools (port of ``repro/serve/paging/manager.py``).

Owns the (n_slots, NB) block tables the decode step consumes, the
admission / reservation bookkeeping per slot, and the byte accounting
against the dense pool.  The device pools are built by
``models.transformer.init_paged_caches`` and written by the surgery in
``repro_torch.train.serve`` — the manager only decides WHICH pages those
touch.

With ``prefix_cache=True`` the manager also runs a
:class:`~repro_torch.serve.paging.radix.RadixCache` over retired prompts:

  * ``plan_prefix`` matches a new prompt against the tree and quantizes the
    hit down to the engine's chunk grid (and to ``prompt_len - 1`` — the
    last prompt token is always recomputed to produce first-token logits),
    so a warm request resumes chunked prefill exactly at a chunk boundary
    the cold run also hit: identical tokens.
  * ``admit`` binds the matched pages into the slot's block table without
    copying, pins them for the request's lifetime, and — when the hit ends
    mid-page — charges one reservation page for a copy-on-write of the
    boundary page (``cow_moves`` hands the engine the device copy).
  * ``donate`` interns a completed prompt's full pages into the tree
    (first writer wins).

With ``spec_draft_k > 0`` it reserves pinned scratch pages at construction
for speculative verifies (``spec_begin`` / ``spec_commit`` /
``spec_rollback``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import init_paged_caches
from repro_torch.serve.paging.allocator import SENTINEL, PageAllocator
from repro_torch.serve.paging.radix import RadixCache


def _dtype_bytes(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def attn_kv_bytes_per_row(cfg) -> int:
    """Bytes of K+V cache per context row across the whole layer stack
    (attention pattern positions only — recurrent state has no row axis)."""
    n_attn = sum(1 for spec in cfg.pattern if spec.mixer == "attn")
    return 2 * n_attn * cfg.repeats * cfg.n_kv_heads * cfg.hd * _dtype_bytes(cfg.compute_dtype)


def dense_cache_bytes(cfg, n_slots: int, max_len: int) -> int:
    """What the dense pool permanently holds for its attention caches."""
    return attn_kv_bytes_per_row(cfg) * n_slots * max_len


class PrefixPlan:
    """Admission-time plan from one radix lookup: what to share, what to COW,
    and where chunked prefill may resume."""

    __slots__ = ("hit", "shared", "cow_src", "matched_tokens")

    def __init__(self, hit: int, shared: List[int], cow_src: Optional[int], matched_tokens: int):
        self.hit = hit  # chunk-aligned cached rows (prefill resumes here)
        self.shared = shared  # fully covered pages to bind read-only
        self.cow_src = cow_src  # page to copy when the hit ends mid-page
        self.matched_tokens = matched_tokens  # raw (unquantized) match length

    @property
    def pin_pages(self) -> List[int]:
        """All pages this plan must pin (shared pages + the COW source)."""
        return self.shared + ([self.cow_src] if self.cow_src is not None else [])


class SpecTicket:
    """One in-flight speculative verify for one slot: which logical blocks
    were remapped to scratch pages, and the scratch-mapped table row the
    verify forward reads and writes through.  Made by
    :meth:`PagedKVManager.spec_begin`, settled by exactly one of
    :meth:`PagedKVManager.spec_commit` / :meth:`PagedKVManager.spec_rollback`."""

    __slots__ = ("slot", "pos", "k_eff", "blocks", "scratch", "row")

    def __init__(self, slot: int, pos: int, k_eff: int, blocks: List[int], scratch: List[int], row: np.ndarray):
        self.slot = slot
        self.pos = pos  # next write row (the slot's cache_len)
        self.k_eff = k_eff  # draft tokens actually scored this tick
        self.blocks = blocks  # logical blocks remapped to scratch
        self.scratch = scratch  # scratch physical ids, parallel to blocks
        self.row = row  # (NB,) table row with blocks -> scratch


class PagedKVManager:
    """Block tables + reservation accounting for one slot pool."""

    def __init__(
        self,
        cfg,
        n_slots: int,
        max_len: int,
        page: int,
        total_pages: Optional[int] = None,
        prefix_cache: bool = False,
        prefix_chunk: Optional[int] = None,
        spec_draft_k: int = 0,
    ):
        assert max_len % page == 0, (
            f"max_len={max_len} must be a multiple of the page size {page} "
            "(the engine rounds up at construction)"
        )
        if not any(spec.mixer == "attn" for spec in cfg.pattern):
            raise ValueError(
                "paged KV cache needs at least one attention position in the "
                "pattern; SSM/RWKV state is O(1) per slot and is never paged"
            )
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.page = int(page)
        self.blocks_per_slot = max_len // page
        # speculative scratch: a verify touching rows [pos, pos + k] spans at
        # most ceil((page - 1 + k) / page) + 1 blocks (pos at the last row of
        # a page), per slot, per tick
        self.spec_draft_k = int(spec_draft_k)
        self.spec_blocks_per_slot = (page - 1 + self.spec_draft_k) // page + 1 if self.spec_draft_k else 0
        n_scratch = self.n_slots * self.spec_blocks_per_slot
        # +1: the sentinel page.  The default pool matches dense capacity;
        # the memory win comes from sizing total_pages to the workload, while
        # reservation accounting keeps admission OOM-safe.  Speculation adds
        # its scratch pages on top, so requests see the same capacity.
        self.total_pages = int(total_pages or (self.n_slots * self.blocks_per_slot + 1 + n_scratch))
        self.alloc = PageAllocator(self.total_pages, page, n_slots, self.blocks_per_slot)
        # scratch pages are allocated and pinned up front: the pin charges
        # them against `reserved + pinned <= usable`, so speculative writes
        # can never OOM an admitted slot
        self._spec_free: List[int] = self.alloc.alloc_pinned(n_scratch) if n_scratch else []
        self.prefix_cache = bool(prefix_cache)
        self.radix: Optional[RadixCache] = None
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.prefix_cow_total = 0
        if self.prefix_cache:
            if not prefix_chunk or int(prefix_chunk) < 1:
                raise ValueError(
                    "prefix_cache quantizes hits to the chunked-prefill grid; "
                    "pass prefix_chunk (the engine's prefill_chunk)"
                )
            self.prefix_chunk = int(prefix_chunk)
            self.radix = RadixCache(self.page, self.alloc)
            self.alloc.evict_hook = self._evict_for
        # per-slot prefix state (only populated under prefix_cache)
        self._plans: Dict[int, PrefixPlan] = {}
        self._pins: Dict[int, List[int]] = {}
        self._cow: Dict[int, Optional[Tuple[int, int]]] = {}

    def init_caches(self, device=None):
        """Allocate the pool's page pools (all tables start on the sentinel)
        beside the per-slot recurrent state of any Mamba / RWKV position."""
        return init_paged_caches(self.cfg, self.total_pages, self.page, device, batch=self.n_slots)

    # -- block tables ---------------------------------------------------------

    def table_row(self, slot: int) -> np.ndarray:
        """(NB,) int32 physical page ids for one slot, sentinel-padded."""
        row = np.full((self.blocks_per_slot,), SENTINEL, np.int32)
        tbl = self.alloc.table(slot)
        row[: len(tbl)] = tbl
        return row

    def block_tables(self) -> np.ndarray:
        """(n_slots, NB) int32 — what every paged decode step consumes."""
        return np.stack([self.table_row(s) for s in range(self.n_slots)], axis=0)

    def scatter_row(self, slot: int) -> np.ndarray:
        """Table row for the final-chunk scatter: fully shared prefix blocks
        are masked to the sentinel so the insert never rewrites a read-only
        shared page."""
        row = self.table_row(slot)
        plan = self._plans.get(slot)
        if plan is not None:
            row[: len(plan.shared)] = SENTINEL
        return row

    def reset_row(self, slot: int) -> np.ndarray:
        """Table row for the retire-time zeroing: any page another owner
        still maps (shared prefixes, donated pages) is masked out — only the
        slot's exclusive pages are scrubbed."""
        row = self.table_row(slot)
        for j, phys in enumerate(self.alloc.table(slot)):
            if self.alloc.refcount(phys) > 1:
                row[j] = SENTINEL
        return row

    # -- admission / growth / retirement --------------------------------------

    def rows_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Cache rows a request writes: ``prompt + max_new - 1`` (the last
        emitted token is never written)."""
        return prompt_len + max_new_tokens - 1

    def fits_ever(self, prompt_len: int, max_new_tokens: int) -> bool:
        """True if the request could ever fit an empty pool."""
        return self.alloc.fits_ever(self.rows_needed(prompt_len, max_new_tokens))

    def plan_prefix(self, tokens, prompt_len: int) -> PrefixPlan:
        """Match a prompt against the radix tree and quantize the hit to the
        chunk grid (never past ``prompt_len - 1``: the final prompt token is
        always recomputed so the first emitted token gets real logits)."""
        m = self.radix.match(tokens[:prompt_len])
        hit = min(m.tokens, prompt_len - 1)
        hit = (hit // self.prefix_chunk) * self.prefix_chunk
        full = hit // self.page
        shared = m.pages[:full]
        cow_src = None
        if hit % self.page:
            # the hit covers part of page `full`; a matched page must exist
            cow_src = m.pages[full] if full < len(m.pages) else m.partial
            assert cow_src is not None, (hit, m.tokens, len(m.pages))
        return PrefixPlan(hit, shared, cow_src, m.tokens)

    def can_admit(self, prompt_len: int, max_new_tokens: int, plan: Optional[PrefixPlan] = None) -> bool:
        """True if the (unshared) reservation fits the pool right now."""
        rows = self.rows_needed(prompt_len, max_new_tokens)
        if plan is None:
            return self.alloc.can_reserve(rows)
        new_pins = sum(1 for p in plan.pin_pages if self.alloc.pin_count(p) == 0)
        return self.alloc.can_reserve(rows, shared_pages=len(plan.shared), new_pins=new_pins)

    def admit(self, slot: int, prompt_len: int, max_new_tokens: int, plan: Optional[PrefixPlan] = None) -> int:
        """Reserve + (under prefix caching) bind and pin the plan's pages.
        Returns the row the slot's chunked prefill may resume at (0 cold).
        Pins come before the COW allocation so on-demand eviction inside
        ``cow_bind`` can never free a page this plan depends on."""
        rows = self.rows_needed(prompt_len, max_new_tokens)
        if plan is None:
            self.alloc.reserve(slot, rows)
            if self.prefix_cache:
                self.prefix_misses += 1
            return 0
        self.alloc.reserve(slot, rows, shared_pages=len(plan.shared))
        pins = plan.pin_pages
        for phys in pins:
            self.alloc.pin_page(phys)
        self._pins[slot] = pins
        self.alloc.bind_shared(slot, plan.shared)
        cow = None
        if plan.cow_src is not None:
            cow = (plan.cow_src, self.alloc.cow_bind(slot, plan.cow_src))
            self.prefix_cow_total += 1
        self._cow[slot] = cow
        self._plans[slot] = plan
        if plan.hit > 0:
            self.prefix_hits += 1
            self.prefix_hit_tokens += plan.hit
        else:
            self.prefix_misses += 1
        return plan.hit

    def prefix_hit(self, slot: int) -> int:
        """Cached rows the slot's prefill skipped (0 when cold or unshared)."""
        plan = self._plans.get(slot)
        return plan.hit if plan is not None else 0

    def cow_moves(self, slot: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The slot's pending copy-on-write as one-move (src, dst) vectors
        (``apply_page_moves`` layout), or None.  Consumed on the first call:
        the copy runs once, before the first warm chunk."""
        cow = self._cow.get(slot)
        if cow is None:
            return None
        self._cow[slot] = None
        return np.asarray([cow[0]], np.int32), np.asarray([cow[1]], np.int32)

    def ensure_rows(self, slot: int, n_rows: int) -> List[Tuple[int, int]]:
        """Guarantee the slot's table covers ``n_rows`` written rows."""
        return self.alloc.ensure(slot, n_rows)

    # -- speculative scratch lifecycle ----------------------------------------
    #
    # A verify tick for one slot reads committed rows < pos and writes the
    # k_eff + 1 lane inputs at rows [pos, pos + k_eff] WITHOUT dirtying the
    # slot's real pages (a truncated draft leaves no trace).  spec_begin
    # remaps every touched logical block to a scratch page — copying the one
    # partly committed boundary page so reads stay identical — and the verify
    # runs through that remapped row.  spec_commit then SWAPS the scratch
    # pages into the block table (the displaced pages become scratch: no copy
    # on the accept path); spec_rollback returns the scratch pages, leaving
    # table and positions untouched.

    def spec_begin(self, slot: int, pos: int, k_eff: int) -> Tuple[SpecTicket, List[Tuple[int, int]]]:
        """Open a speculative verify window for ``slot`` at row ``pos``.
        Returns the ticket and the (src, dst) page copies the engine applies
        BEFORE the verify forward: only the boundary block holding committed
        rows needs a copy (rows >= ``pos`` hold no live data)."""
        b0 = pos // self.page
        b1 = (pos + k_eff) // self.page
        blocks = list(range(b0, b1 + 1))
        if len(blocks) > self.spec_blocks_per_slot:
            raise RuntimeError(
                f"verify spans {len(blocks)} blocks > scratch budget {self.spec_blocks_per_slot} (k_eff={k_eff})"
            )
        scratch = [self._spec_free.pop() for _ in blocks]
        row = self.table_row(slot)
        copies: List[Tuple[int, int]] = []
        if pos % self.page:
            copies.append((int(row[b0]), scratch[0]))
        for b, s in zip(blocks, scratch):
            row[b] = s
        return SpecTicket(slot, pos, k_eff, blocks, scratch, row), copies

    def spec_commit(self, ticket: SpecTicket, n_written: int):
        """Promote a verified span into the slot's block table.
        ``n_written`` is the accepted input rows (``1 + accepted draft``;
        lane 0's write is the one plain decode would have made, so >= 1).
        Blocks covering those rows swap their scratch page in (the displaced
        page becomes scratch: a table edit, no device copy); scratch beyond
        the span returns unused.  Real pages for newly covered blocks are
        ensured here, never in spec_begin, so a rollback stays exact."""
        assert n_written >= 1, n_written
        self.ensure_rows(ticket.slot, ticket.pos + n_written)
        last_block = (ticket.pos + n_written - 1) // self.page
        for b, s in zip(ticket.blocks, ticket.scratch):
            if b <= last_block:
                self._spec_free.append(self.alloc.swap_page(ticket.slot, b, s))
            else:
                self._spec_free.append(s)

    def spec_rollback(self, ticket: SpecTicket):
        """Discard a speculative window: scratch pages return to the pool and
        the block table and reservations are exactly as before
        ``spec_begin`` (stale writes on the scratch pages are dead data)."""
        self._spec_free.extend(ticket.scratch)

    def donate(self, slot: int, tokens) -> int:
        """Intern the slot's full prompt pages into the radix tree at the end
        of prefill (first writer wins).  Returns pages newly cached."""
        if self.radix is None:
            return 0
        full = len(tokens) // self.page
        if full == 0:
            return 0
        pages = self.alloc.table(slot)[:full]
        return len(self.radix.insert(tokens[: full * self.page], pages))

    def release(self, slot: int):
        """Return a slot's pages, pins and reservation to the pool."""
        for phys in self._pins.pop(slot, []):
            self.alloc.unpin_page(phys)
        self._cow.pop(slot, None)
        self._plans.pop(slot, None)
        self.alloc.release(slot)

    def _evict_for(self, need: int) -> int:
        return self.radix.evict(need)

    def plan_compaction(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) page-move vectors for ``train.serve.apply_page_moves``
        (empty when already compact)."""
        moves = self.alloc.plan_compaction(self.blocks_per_slot)
        src = np.asarray([s for s, _ in moves], np.int32)
        dst = np.asarray([d for _, d in moves], np.int32)
        return src, dst

    # -- byte accounting -------------------------------------------------------

    @property
    def page_bytes(self) -> int:
        """Bytes of KV state one page holds across all attention layers."""
        return attn_kv_bytes_per_row(self.cfg) * self.page

    def peak_cache_bytes(self) -> int:
        """High-water mark of concurrently allocated page bytes."""
        return self.alloc.peak_pages * self.page_bytes

    def pool_cache_bytes(self) -> int:
        """Total bytes of the pool's usable pages."""
        return self.alloc.usable_pages * self.page_bytes

    def dense_equiv_bytes(self) -> int:
        """Bytes the dense per-slot pool would reserve instead."""
        return dense_cache_bytes(self.cfg, self.n_slots, self.max_len)

    def metrics(self, prefix: str = "paged_") -> Dict[str, float]:
        """Allocator counters plus the byte, prefix and scratch gauges, one
        flat dict."""
        out = {f"{prefix}{k}": v for k, v in self.alloc.metrics(prefix="pages_").items()}
        usable = self.alloc.usable_pages
        out[f"{prefix}pages_utilization"] = self.alloc.in_use / usable if usable else 0.0
        out[f"{prefix}page_tokens"] = float(self.page)
        if self.spec_draft_k:
            out[f"{prefix}spec_scratch_pages"] = float(self.n_slots * self.spec_blocks_per_slot)
            out[f"{prefix}spec_scratch_free"] = float(len(self._spec_free))
        out[f"{prefix}peak_cache_bytes"] = float(self.peak_cache_bytes())
        out[f"{prefix}pool_cache_bytes"] = float(self.pool_cache_bytes())
        out[f"{prefix}dense_equiv_bytes"] = float(self.dense_equiv_bytes())
        if self.prefix_cache:
            lookups = self.prefix_hits + self.prefix_misses
            out[f"{prefix}prefix_hit_rate"] = self.prefix_hits / lookups if lookups else 0.0
            out[f"{prefix}shared_pages"] = float(self.alloc.shared_pages)
            out[f"{prefix}prefix_hits_total"] = float(self.prefix_hits)
            out[f"{prefix}prefix_misses_total"] = float(self.prefix_misses)
            out[f"{prefix}prefix_hit_tokens_total"] = float(self.prefix_hit_tokens)
            out[f"{prefix}prefix_cow_total"] = float(self.prefix_cow_total)
            out.update(self.radix.metrics(prefix=f"{prefix}radix_"))
        return out
