"""Plain oracle for paged decode attention (port of
``repro/kernels/paged_attention/ref.py``).

Materializes the dense (B, NB * page, H, hd) context view with one gather
over the block table and evaluates masked softmax attention in f32.  Heads
are already GQA-expanded here (``ops.paged_decode_plain`` expands them).

  q             (B, H, hd)       one query token per pool slot
  k/v_pages     (P, page, H, hd) physical page pool
  block_tables  (B, NB) int      logical block j of slot b -> physical page
  lens          (B,) int         valid context tokens per slot

A pool may hold one block of a longer cache (a rank's rows of a cache split
by sequence): ``start`` is the global row of the pool's row 0, ``lens`` stay
global, and the log-sum-exp of the block's scores lets the blocks' partial
softmaxes be merged exactly (``parallel/fsdp_tp.merge_partials``).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor
NEG_INF = -1e30


def gather_pages(pages: Tensor, block_tables: Tensor) -> Tensor:
    """(P, page, H, hd) pages + (B, NB) table -> (B, NB * page, H, hd) dense
    view (rows beyond a slot's length hold arbitrary page content)."""
    b, nb = block_tables.shape
    _, page, h, hd = pages.shape
    return pages[block_tables.long()].reshape(b, nb * page, h, hd)


def paged_decode_ref(
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
    """Masked softmax attention over the gathered page view; ``window > 0``
    keeps rows [len - window, len), ``softcap > 0`` applies the tanh cap.
    The view's row t is global row ``start + t``.  Returns (B, H, hd) f32,
    and with ``return_lse`` also the (B, H) f32 log-sum-exp of the scaled,
    capped scores of the live rows; a slot with no live row in the view
    gives out 0 and LSE -inf."""
    k = gather_pages(k_pages, block_tables).float()
    v = gather_pages(v_pages, block_tables).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    ki = torch.arange(k.shape[1], device=q.device)[None, None, :]
    if start:
        ki = ki + int(start)
    cl = lens.reshape(-1, 1, 1).long()
    mask = ki < cl
    if window:
        mask &= ki >= cl - window
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    total = torch.sum(p, dim=-1, keepdim=True)
    p = p / torch.clamp(total, min=1e-30)
    out = torch.einsum("bhk,bkhd->bhd", p, v)
    if not (start or return_lse):
        return out
    live = mask.any(dim=-1)  # (B, 1 or H)
    out = torch.where(live[..., None], out, 0.0)
    if not return_lse:
        return out
    lse = torch.where(live, (m + torch.log(total))[..., 0], float("-inf"))
    return out, lse.expand(out.shape[:2]).contiguous()
