"""PagedKVManager: the bridge between the host-side ``PageAllocator`` and
the device-side page pools (port of ``repro/serve/paging/manager.py``,
without the prefix plan and the speculative scratch pages).

Owns the (n_slots, NB) block tables the decode step consumes, the
admission / reservation bookkeeping per slot, and the byte accounting
against the dense pool.  The device pools are built by
``models.transformer.init_paged_caches`` and written by the surgery in
``repro_torch.train.serve`` — the manager only decides WHICH pages those
touch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import init_paged_caches
from repro_torch.serve.paging.allocator import SENTINEL, PageAllocator


def _dtype_bytes(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def attn_kv_bytes_per_row(cfg) -> int:
    """Bytes of K+V cache per context row across the whole layer stack."""
    n_attn = sum(1 for spec in cfg.pattern if spec.mixer == "attn")
    return 2 * n_attn * cfg.repeats * cfg.n_kv_heads * cfg.hd * _dtype_bytes(cfg.compute_dtype)


def dense_cache_bytes(cfg, n_slots: int, max_len: int) -> int:
    """What the dense pool permanently holds for its attention caches."""
    return attn_kv_bytes_per_row(cfg) * n_slots * max_len


class PagedKVManager:
    """Block tables + reservation accounting for one slot pool."""

    def __init__(self, cfg, n_slots: int, max_len: int, page: int, total_pages: Optional[int] = None):
        assert max_len % page == 0, (
            f"max_len={max_len} must be a multiple of the page size {page} "
            "(the engine rounds up at construction)"
        )
        if not any(spec.mixer == "attn" for spec in cfg.pattern):
            raise ValueError("paged KV cache needs at least one attention position in the pattern")
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.page = int(page)
        self.blocks_per_slot = max_len // page
        # +1: the sentinel page.  The default pool matches dense capacity;
        # the memory win comes from sizing total_pages to the workload, while
        # reservation accounting keeps admission OOM-safe.
        self.total_pages = int(total_pages or (self.n_slots * self.blocks_per_slot + 1))
        self.alloc = PageAllocator(self.total_pages, page, n_slots, self.blocks_per_slot)

    def init_caches(self, device=None):
        """Allocate the pool's page pools (all tables start on the sentinel)."""
        return init_paged_caches(self.cfg, self.total_pages, self.page, device)

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

    # -- admission / growth / retirement --------------------------------------

    def rows_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Cache rows a request writes: ``prompt + max_new - 1`` (the last
        emitted token is never written)."""
        return prompt_len + max_new_tokens - 1

    def fits_ever(self, prompt_len: int, max_new_tokens: int) -> bool:
        """True if the request could ever fit an empty pool."""
        return self.alloc.fits_ever(self.rows_needed(prompt_len, max_new_tokens))

    def can_admit(self, prompt_len: int, max_new_tokens: int) -> bool:
        """True if the request's worst-case reservation fits the pool now."""
        return self.alloc.can_reserve(self.rows_needed(prompt_len, max_new_tokens))

    def admit(self, slot: int, prompt_len: int, max_new_tokens: int) -> int:
        """Reserve the request's worst-case pages; returns the pages charged."""
        return self.alloc.reserve(slot, self.rows_needed(prompt_len, max_new_tokens))

    def ensure_rows(self, slot: int, n_rows: int) -> List[Tuple[int, int]]:
        """Guarantee the slot's table covers ``n_rows`` written rows."""
        return self.alloc.ensure(slot, n_rows)

    def release(self, slot: int):
        """Return a slot's pages and reservation to the pool."""
        self.alloc.release(slot)

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
        """Allocator counters plus the byte gauges, one flat dict."""
        out = {f"{prefix}{k}": v for k, v in self.alloc.metrics(prefix="pages_").items()}
        usable = self.alloc.usable_pages
        out[f"{prefix}pages_utilization"] = self.alloc.in_use / usable if usable else 0.0
        out[f"{prefix}page_tokens"] = float(self.page)
        out[f"{prefix}peak_cache_bytes"] = float(self.peak_cache_bytes())
        out[f"{prefix}pool_cache_bytes"] = float(self.pool_cache_bytes())
        out[f"{prefix}dense_equiv_bytes"] = float(self.dense_equiv_bytes())
        return out
