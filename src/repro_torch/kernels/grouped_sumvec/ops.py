"""Grouped sumvec (paper Eq. 13) over the ``pmatmul`` / ``freq_outer`` kernels.

Port of ``repro/kernels/grouped_sumvec/ops.py``.  Autograd runs through the
kernels' own vjps (``kernel.py``); the constant bases' transposes those need
are cached beside the bases.  Pipeline:

  Z (n, d) --blockify--> (n, nb, b)
    --pmatmul with [Cr | Ci] (block DFT)--> F_r, F_i (n, nb, nf)
    --transpose--> (nf, n, nb)
    --freq_outer x2--> G_r, G_i (nf, nb, nb)      # "compressed outer product"
    --q=2: Parseval in torch (O(nb^2 nf));  q=1: pmatmul with synthesis basis

Complexity: O(n d b) for the DFT + O(n (d/b)^2 b) for the pairwise stage.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.sumvec import rfft_parseval_weights
from repro_torch.kernels.grouped_sumvec import kernel as K
from repro_torch.kernels.utils import dft_matrices, irfft_basis, tensor_cache
from repro_torch.tune.space import grouped_block_size_candidates

Tensor = torch.Tensor


def auto_block_size(d: int, prefer: int = 128) -> int:
    """A default block size b for width d: the largest legal candidate <= ``prefer``.

    The paper (Fig. 3) finds b = 128 the accuracy sweet spot; widths below
    ``prefer`` get b = d (ungrouped, Eq. 6).  b is part of the LOSS
    definition — this helper is for call sites choosing a b, never applied
    silently inside ``r_sum_kernel``.
    """
    legal = grouped_block_size_candidates(d)
    return max(b for b in legal if b <= prefer)


def _blockify(z: Tensor, b: int) -> Tensor:
    n, d = z.shape
    rem = (-d) % b
    if rem:
        z = F.pad(z, (0, rem))
    return z.reshape(n, -1, b)


@tensor_cache(maxsize=32)
def _dft_basis(b: int, device=None) -> Tensor:
    cr, ci = dft_matrices(b, device)
    return torch.cat([cr, ci], dim=1).contiguous()  # (b, 2 nf), read-only


@tensor_cache(maxsize=32)
def _dft_basis_t(b: int, device=None) -> Tensor:
    return _dft_basis(b, device).T.contiguous()  # (2 nf, b), for the vjp


@tensor_cache(maxsize=32)
def _synthesis_t(b: int, device=None) -> Tuple[Tensor, Tensor]:
    br, bi = irfft_basis(b, device)
    return br.T.contiguous(), bi.T.contiguous()  # (b, nf) each, for the vjp


def block_dft(z: Tensor, b: int) -> Tuple[Tensor, Tensor]:
    """Per-block rfft of (n, d) via one matmul kernel. Returns (nf, n, nb) x2."""
    zb = _blockify(z.float(), b)
    n, nb, _ = zb.shape
    nf = b // 2 + 1
    basis, basis_t = _dft_basis(b, z.device), _dft_basis_t(b, z.device)
    f = K.pmatmul(zb.reshape(n * nb, b).contiguous(), basis, basis_t)  # (n*nb, 2 nf)
    f = f.reshape(n, nb, 2 * nf)
    fr = f[..., :nf].permute(2, 0, 1)  # (nf, n, nb)
    fi = f[..., nf:].permute(2, 0, 1)
    return fr, fi


def grouped_frequency_accumulator_kernel(
    z1: Tensor, z2: Tensor, block_size: int
) -> Tuple[Tensor, Tensor]:
    """G[i,j,f] = sum_k conj(F1[k,i,f]) F2[k,j,f], returned as (nf, nb, nb)
    real/imag pair (frequency-major)."""
    b = int(block_size)
    f1r, f1i = block_dft(z1, b)
    f2r, f2i = (f1r, f1i) if z2 is z1 else block_dft(z2, b)
    # G_r = F1r^T F2r + F1i^T F2i ; G_i = F1r^T F2i - F1i^T F2r  (per f)
    a_r = torch.cat([f1r, f1i], dim=1)
    b_r = torch.cat([f2r, f2i], dim=1)
    g_r = K.freq_outer(a_r, b_r)
    a_i = torch.cat([f1r, -f1i], dim=1)
    b_i = torch.cat([f2i, f2r], dim=1)
    g_i = K.freq_outer(a_i, b_i)
    return g_r, g_i


def reg_from_planes(g_r: Tensor, g_i: Tensor, b: int, q: int = 2) -> Tensor:
    """Eq. (13) from the (already normalized) accumulator planes, each
    (nf, nb, nb) frequency-major: Parseval in torch for q = 2, the
    synthesis basis through ``pmatmul`` for q = 1."""
    nb = g_r.shape[1]
    w = rfft_parseval_weights(b, g_r.device)[:, None, None]
    eye = torch.eye(nb, dtype=torch.float32, device=g_r.device)
    if q == 2:
        sq = torch.sum(w * (g_r**2 + g_i**2), dim=0) / b  # (nb, nb)
        s0 = torch.sum(w * g_r, dim=0) / b
        return torch.sum(sq) - torch.sum(eye * s0**2)
    # q = 1: synthesize the time-domain summary vectors with one more matmul.
    br, bi = irfft_basis(b, g_r.device)  # (nf, b) each
    nf = g_r.shape[0]
    gr_flat = g_r.permute(1, 2, 0).reshape(nb * nb, nf).contiguous()
    gi_flat = g_i.permute(1, 2, 0).reshape(nb * nb, nf).contiguous()
    br_t, bi_t = _synthesis_t(b, g_r.device)
    sv = K.pmatmul(gr_flat, br, br_t) + K.pmatmul(gi_flat, bi, bi_t)  # (nb*nb, b)
    sv = sv.reshape(nb, nb, b)
    full = torch.sum(torch.abs(sv), dim=-1)
    return torch.sum(full) - torch.sum(eye * torch.abs(sv[..., 0]))


def r_sum_kernel(
    z1: Tensor,
    z2: Tensor,
    *,
    block_size: Optional[int],
    q: int = 2,
    scale: Optional[float] = None,
) -> Tensor:
    """Eq. (13) (or Eq. 6 when the block covers d) through the kernel pipeline."""
    d = z1.shape[-1]
    b = int(block_size) if block_size is not None else d
    b = min(b, d)
    s = 1.0 if scale is None else float(scale)
    g_r, g_i = grouped_frequency_accumulator_kernel(z1, z2, b)
    return reg_from_planes(g_r / s, g_i / s, b, q)
