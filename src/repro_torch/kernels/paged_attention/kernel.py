"""The paged decode-attention kernel: ``paged_decode_attention``.

Port of ``repro/kernels/paged_attention/kernel.py``.  The CUDA C++ source
is ``kernels/csrc/paged_attention.cu``, whose header note names the TPU
kernel it replaces, its bound on an H100 and its design: one block per
(slot, kv head, split) holds that head's ``n_rep`` query rows and walks
``CHUNK`` of the slot's live rows through its own block-table entries with
an online softmax; with more than one split a second pass of the same C
entry merges the splits' partial states in a fixed order.  The split count
(``split_count``) comes from the table's width, the page size and the
window alone, so the wrapper never reads the lengths on the host.

The wrapper checks device, dtypes, shapes and contiguity, runs the plain
version (``ops.paged_decode_plain``) for CPU tensors and launches the
kernel for CUDA tensors or raises — there is no fallback.  Inference only:
no autograd rule, so ``launches_bwd`` stays 0.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, count_launch
from repro_torch.kernels.paged_attention.ops import paged_decode_plain
from repro_torch.kernels.utils import route

Tensor = torch.Tensor
FAMILY = "paged_attention"
# the kernel keeps a warp's share of each head row and of every query row of
# a kv head in registers: hd <= 32 * 8 and n_rep <= 8 (gemma2: 256 and 2)
MAX_HEAD_DIM = 256
MAX_N_REP = 8
PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# rows of a slot one block of the kernel takes (``CH`` in paged_attention.cu)
CHUNK = 256


def split_count(nb: int, page: int, window: int) -> int:
    """Blocks a (slot, kv head) is split over: enough CHUNK-row chunks for
    the most live rows a slot of an (NB, page) table can hold under
    ``window`` — from sizes the host knows, never from the lengths."""
    rows = nb * page if not window else min(nb * page, window)
    return max(1, -(-rows // CHUNK))


def _check(name: str, x: Tensor, shape, dtypes) -> None:
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"paged_attention {name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"paged_attention {name}: expected dtype in {dtypes}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"paged_attention {name}: expected a contiguous tensor")


def paged_decode_attention(
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
    """One decode step of GQA attention over block-table pages.

    q: (B, H, hd) f32; k/v_pages: (P, page, KV, hd) f32 or bf16, H a
    multiple of KV (never head-expanded); block_tables: (B, NB) int32;
    lens: (B,) int32 valid rows per slot, 1 <= len <= NB * page (rows at ``pos >= len``,
    and with ``window > 0`` rows at ``pos < len - window``, carry no
    probability mass).  Returns (B, H, hd) f32.
    """
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"paged_attention: expected q (B, H, hd) and pages (P, page, KV, hd), got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}")
    b, h, hd = q.shape
    p_total, page, kv, hd_k = k_pages.shape
    if hd_k != hd or h % kv:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not match pages {tuple(k_pages.shape)}")
    if route(q, k_pages, v_pages, block_tables, lens) == "cpu":
        return paged_decode_plain(
            q, k_pages, v_pages, block_tables, lens, scale=scale, softcap=softcap, window=window
        )
    n_rep = h // kv
    nb = block_tables.shape[-1]
    if hd > MAX_HEAD_DIM or n_rep > MAX_N_REP:
        raise ValueError(f"paged_attention: head_dim {hd} > {MAX_HEAD_DIM} or n_rep {n_rep} > {MAX_N_REP}")
    _check("q", q, (b, h, hd), (torch.float32,))
    _check("k_pages", k_pages, (p_total, page, kv, hd), tuple(PAGE_DTYPES))
    _check("v_pages", v_pages, (p_total, page, kv, hd), (k_pages.dtype,))
    _check("block_tables", block_tables, (b, nb), (torch.int32,))
    _check("lens", lens, (b,), (torch.int32,))
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention: page pools must start on a 16-byte boundary (the kernel's vector loads)")
    out = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    if b:
        window = int(window or 0)
        splits = split_count(nb, page, window)
        # the splits' partial states: (B, KV, S, n_rep, hd) accumulators, then
        # (B, KV, S, n_rep, 2) running max and normaliser
        part = torch.empty((b * kv * splits * n_rep * (hd + 2),), dtype=torch.float32, device=q.device) \
            if splits > 1 else None
        build.launch(
            FAMILY, "decode", q.device, q, k_pages, v_pages, block_tables, lens, out, part,
            b, kv, n_rep, hd, page, nb, splits, float(scale), float(softcap or 0.0), window,
            PAGE_DTYPES[k_pages.dtype],
        )
        count_launch(paged_decode_attention)
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_bwd = 0
