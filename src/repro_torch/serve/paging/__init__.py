"""repro_torch.serve.paging — paged KV cache for the continuous-batching
slot pool (port of ``repro/serve/paging``).

  * ``allocator`` — ``PageAllocator``: min-heap free list of fixed-size
    token pages, sentinel page 0, reservation-based OOM-safe admission,
    refcount / pin accounting for shared pages, copy-on-retire compaction
    planning (pure Python, copied);
  * ``manager``   — ``PagedKVManager``: the (n_slots, NB) block tables the
    decode step consumes, the device pools, prefix-plan admission, the
    speculative scratch pages and the byte accounting;
  * ``radix``     — ``RadixCache``: page-granular prefix interning of retired
    prompts with LRU tail-truncation eviction (pure Python, copied).
"""

from repro_torch.serve.paging.allocator import SENTINEL, PageAllocator, pages_for
from repro_torch.serve.paging.manager import (
    PagedKVManager,
    PrefixPlan,
    SpecTicket,
    attn_kv_bytes_per_row,
    dense_cache_bytes,
)
from repro_torch.serve.paging.radix import PrefixMatch, RadixCache, RadixNode

__all__ = [
    "PageAllocator",
    "PagedKVManager",
    "PrefixMatch",
    "PrefixPlan",
    "RadixCache",
    "RadixNode",
    "SENTINEL",
    "SpecTicket",
    "attn_kv_bytes_per_row",
    "dense_cache_bytes",
    "pages_for",
]
