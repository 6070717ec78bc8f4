"""Summary-vector (``sumvec``) primitives — the paper's Eq. (5)–(12), plain route.

Port of ``repro/core/sumvec.py`` on ``torch.fft``.  The summary vector of a
square matrix C collects its wrapped diagonals::

    [sumvec(C)]_i = sum_j C[j, (i + j) mod d]          (Eq. 5)

and for C = (1/s) sum_k a_k b_k^T it equals an average of circular
correlations, computed without materializing C (Eq. 12)::

    sumvec(C) = (1/s) * F^-1( sum_k conj(F(a_k)) o F(b_k) )

FFT work runs in float32 whatever the input dtype.  This is the route CPU
tensors take (and the plain reference on the card); CUDA tensors take the
kernel pipelines in ``repro_torch.kernels``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def sumvec_from_matrix(c: Tensor) -> Tensor:
    """Eq. (5): summary vector of a square matrix (last two axes). O(d^2)."""
    d = c.shape[-1]
    i = torch.arange(d, device=c.device)[:, None]  # output component
    j = torch.arange(d, device=c.device)[None, :]  # row index
    cols = (i + j) % d
    return torch.sum(c[..., j, cols], dim=-1)


def frequency_accumulator(z1: Tensor, z2: Tensor) -> Tensor:
    """``G = sum_k conj(F(z1_k)) o F(z2_k)`` over rfft bins, complex64.

    ``z1, z2``: (n, d). Returns (d//2 + 1,) complex.
    """
    f1 = torch.fft.rfft(z1.float(), dim=-1)
    f2 = f1 if z2 is z1 else torch.fft.rfft(z2.float(), dim=-1)
    return torch.sum(torch.conj(f1) * f2, dim=0)


def sumvec_fft(z1: Tensor, z2: Tensor, *, scale: Optional[float] = None) -> Tensor:
    """Eq. (12): sumvec of the (scaled) sum of outer products, via FFT.

    ``scale``: divisor s in C = (1/s) sum_k a_k b_k^T (default 1).
    Returns the d-vector sumvec(C) in float32.
    """
    d = z1.shape[-1]
    sv = torch.fft.irfft(frequency_accumulator(z1, z2), n=d, dim=-1)
    if scale is not None:
        sv = sv / scale
    return sv


def pad_to_blocks(z: Tensor, block_size: int) -> Tensor:
    """Zero-pad the trailing feature dim to a multiple of ``block_size``
    (paper §4.4: dummy features constantly 0 in the last group)."""
    rem = (-z.shape[-1]) % block_size
    return F.pad(z, (0, rem)) if rem else z


def blockify(z: Tensor, block_size: int) -> Tensor:
    """(n, d) -> (n, d/b, b) after zero padding."""
    z = pad_to_blocks(z, block_size)
    return z.reshape(z.shape[0], -1, block_size)


def grouped_frequency_accumulator(z1: Tensor, z2: Tensor, block_size: int) -> Tensor:
    """``G[i, j, f] = sum_k conj(F(a_k,i))[f] * F(b_k,j)[f]`` for all block pairs.

    Returns (nb, nb, b//2+1) complex64, nb = ceil(d / b).
    """
    f1 = torch.fft.rfft(blockify(z1.float(), block_size), dim=-1)  # (n, nb, nf)
    f2 = f1 if z2 is z1 else torch.fft.rfft(blockify(z2.float(), block_size), dim=-1)
    return torch.einsum("kif,kjf->ijf", torch.conj(f1), f2)


def rfft_parseval_weights(d: int, device=None) -> Tensor:
    """w_f such that sum_t s[t]^2 = (1/d) sum_f w_f |S_rfft[f]|^2."""
    nf = d // 2 + 1
    w = torch.full((nf,), 2.0, dtype=torch.float32, device=device)
    w[0] = 1.0
    if d % 2 == 0:
        w[-1] = 1.0
    return w


def sq_sum_and_zeroth_from_freq(g: Tensor, d: int) -> Tuple[Tensor, Tensor]:
    """(sum_t s[t]^2, s[0]) of the real length-d signal whose rfft is G
    (last axis = bins), without an inverse transform.

    sum_t s[t]^2 = (1/d) sum_f w_f |G_f|^2           (Parseval)
    s[0]         = (1/d) sum_f w_f Re(G_f)           (DC synthesis)
    """
    w = rfft_parseval_weights(d, g.device)
    sq = torch.sum(w * (g.real**2 + g.imag**2), dim=-1) / d
    s0 = torch.sum(w * g.real, dim=-1) / d
    return sq, s0
