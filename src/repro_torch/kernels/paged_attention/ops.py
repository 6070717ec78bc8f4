"""The plain PyTorch version of the paged-attention kernel (port of
``paged_decode_jnp`` in ``repro/kernels/paged_attention/ops.py``).

The page size is a property of the pool's physical layout, chosen where the
pool is built (``ContinuousLMEngine(page_size=...)``, default 16); the
reference's tuned ``auto_page_size`` arrives with the port's tuner.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import ref as R

Tensor = torch.Tensor


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
) -> Tensor:
    """Gather, expand GQA heads (query head h reads kv head h // n_rep) and
    run the masked softmax in f32: what the kernel computes, materialized.
    q: (B, H, hd); pages: (P, page, KV, hd) in any float dtype (upcast per
    element); returns (B, H, hd) f32."""
    n_rep = q.shape[1] // k_pages.shape[2]
    return R.paged_decode_ref(
        q, _expand_heads(k_pages, n_rep), _expand_heads(v_pages, n_rep), block_tables, lens,
        scale=scale, softcap=softcap, window=window,
    )
