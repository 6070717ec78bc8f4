"""repro_torch.serve.paging — paged KV cache for the continuous-batching
slot pool (port of ``repro/serve/paging``; the prefix radix cache waits for
a later slice).

  * ``allocator`` — ``PageAllocator``: min-heap free list of fixed-size
    token pages, sentinel page 0, reservation-based OOM-safe admission,
    copy-on-retire compaction planning (pure Python, copied);
  * ``manager``   — ``PagedKVManager``: the (n_slots, NB) block tables the
    decode step consumes, the device pools, and the byte accounting.
"""

from repro_torch.serve.paging.allocator import SENTINEL, PageAllocator, pages_for
from repro_torch.serve.paging.manager import PagedKVManager, attn_kv_bytes_per_row, dense_cache_bytes

__all__ = [
    "PageAllocator",
    "PagedKVManager",
    "SENTINEL",
    "attn_kv_bytes_per_row",
    "dense_cache_bytes",
    "pages_for",
]
