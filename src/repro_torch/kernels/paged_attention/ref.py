"""Plain oracle for paged decode attention (port of
``repro/kernels/paged_attention/ref.py``).

Materializes the dense (B, NB * page, H, hd) context view with one gather
over the block table and evaluates masked softmax attention in f32.  Heads
are already GQA-expanded here (``ops.paged_decode_plain`` expands them).

  q             (B, H, hd)       one query token per pool slot
  k/v_pages     (P, page, H, hd) physical page pool
  block_tables  (B, NB) int      logical block j of slot b -> physical page
  lens          (B,) int         valid context tokens per slot
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
) -> Tensor:
    """Masked softmax attention over the gathered page view; ``window > 0``
    keeps rows [len - window, len), ``softcap > 0`` applies the tanh cap.
    Returns (B, H, hd) f32."""
    k = gather_pages(k_pages, block_tables).float()
    v = gather_pages(v_pages, block_tables).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    ki = torch.arange(k.shape[1], device=q.device)[None, None, :]
    cl = lens.reshape(-1, 1, 1).long()
    mask = ki < cl
    if window:
        mask &= ki >= cl - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    return torch.einsum("bhk,bkhd->bhd", p, v)
