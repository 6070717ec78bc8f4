"""Page-size dispatch and the plain PyTorch version of the paged-attention
kernel (port of ``auto_page_size`` and ``paged_decode_jnp`` in
``repro/kernels/paged_attention/ops.py``).

The page size is a property of the pool's physical layout, chosen once
where the pool is built: ``ContinuousLMEngine(page_size=None)`` asks
``auto_page_size``, which asks ``repro_torch.tune`` for the pool's shape.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import ref as R
from repro_torch.tune import space as tune_space
from repro_torch.tune.dispatch import best_config

Tensor = torch.Tensor

# Kernel time alone prefers the largest page (fewest block-table reads, the
# least padding where it divides the context), but every admitted request
# strands on average half a page of dead rows — the fragmentation paging
# exists to remove.  ``auto_page_size`` therefore caps the tuned pick (the
# reference's cap); callers with measured workloads pass their own page.
PAGE_PREFER = 32


def auto_page_size(n_slots: int, max_len: int, n_kv_heads: int, head_dim: int, prefer: int = PAGE_PREFER) -> int:
    """Tuned default page size for a (slots, max_len, kv, hd) pool: the
    ``repro_torch.tune`` winner (override > memo > disk cache > analytic),
    clamped to the largest legal candidate <= ``prefer``."""
    shape = (n_slots, max_len, n_kv_heads, head_dim)
    page = int(best_config("paged_attention", shape)["page"])
    if page <= prefer:
        return page
    legal = [c["page"] for c in tune_space.candidates("paged_attention", shape)]
    capped = [p for p in legal if p <= prefer]
    return max(capped) if capped else min(legal)


def _expand_heads(pages: Tensor, n_rep: int) -> Tensor:
    return pages if n_rep == 1 else torch.repeat_interleave(pages, n_rep, dim=2)


def paged_decode_plain(
    q: Tensor,
    k_pages: Tensor,
    v_pages: Tensor,
    block_tables: Tensor,
    lens: Tensor,
    *,
    scale: float,
    softcap: float = 0.0,
    window: int = 0,
    start: int = 0,
    return_lse: bool = False,
):
    """Gather, expand GQA heads (query head h reads kv head h // n_rep) and
    run the masked softmax in f32: what the kernel computes, materialized.
    q: (B, H, hd); pages: (P, page, KV, hd) in any float dtype (upcast per
    element); returns (B, H, hd) f32.  The pool may be one block of a
    longer cache whose row 0 is global row ``start`` (``lens`` global);
    ``return_lse`` adds the (B, H) f32 log-sum-exp of the block's live
    scores (-inf, and out 0, where a slot has none): ``ref.paged_decode_ref``."""
    n_rep = q.shape[1] // k_pages.shape[2]
    return R.paged_decode_ref(
        q, _expand_heads(k_pages, n_rep), _expand_heads(v_pages, n_rep), block_tables, lens,
        scale=scale, softcap=softcap, window=window, start=start, return_lse=return_lse,
    )
