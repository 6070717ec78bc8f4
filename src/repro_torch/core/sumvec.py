"""Summary-vector (``sumvec``) primitives — the paper's Eq. (5)–(12), plain route.

Port of ``repro/core/sumvec.py`` on ``torch.fft``.  The summary vector of a
square matrix C collects its wrapped diagonals::

    [sumvec(C)]_i = sum_j C[j, (i + j) mod d]          (Eq. 5)

and for C = (1/s) sum_k a_k b_k^T it equals an average of circular
correlations, computed without materializing C (Eq. 12)::

    sumvec(C) = (1/s) * F^-1( sum_k conj(F(a_k)) o F(b_k) )

FFT work runs in float32 whatever the input dtype: the accumulators take no
``precision_dtype`` (the reference's defaults to float32, and no caller asks
for another).  This is the route CPU tensors take (and the plain reference
on the card); CUDA tensors take the kernel pipelines in
``repro_torch.kernels``.  The O(d^2) building blocks and oracles
(``involution``, ``circular_convolve``, ``circular_correlate_naive``,
``sumvec_direct``, ``grouped_sumvec_from_matrix``) are plain PyTorch on the
input's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# sumvec_direct gathers (rows, d, d) f32 per chunk of samples: at most 2^26
# elements (256 MiB) at once, one sample at a time once d > 8192
_DIRECT_CHUNK_ELEMS = 1 << 26


def involution(x: Tensor) -> Tensor:
    """inv(x): reverse components 1..d-1, keep component 0 (paper §4.2).

    ``[inv(x)]_i = [x]_{(d - i) mod d}``. Works on the last axis.
    """
    d = x.shape[-1]
    return x[..., (-torch.arange(d, device=x.device)) % d]


def _cyclic(d: int, sign: int, device) -> Tensor:
    """(d, d) gather index ``(i + sign * j) mod d``: row i = output component."""
    i = torch.arange(d, device=device)[:, None]
    j = torch.arange(d, device=device)[None, :]
    return (i + sign * j) % d


def circular_convolve(x: Tensor, y: Tensor) -> Tensor:
    """Circular convolution x * y along the last axis (Eq. 7). O(d^2) naive.

    ``[x * y]_i = sum_j x_j y_{(i - j) mod d}``.
    """
    return torch.einsum("...j,...ij->...i", x, y[..., _cyclic(x.shape[-1], -1, x.device)])


def circular_correlate_naive(x: Tensor, y: Tensor) -> Tensor:
    """inv(x) * y along the last axis via the direct O(d^2) sum (Appendix A).

    ``[inv(x) * y]_i = sum_j x_j y_{(i + j) mod d}``.
    """
    return _correlate(x, y, _cyclic(x.shape[-1], 1, x.device))


def _correlate(x: Tensor, y: Tensor, index: Tensor) -> Tensor:
    """``circular_correlate_naive`` with its (d, d) gather index given."""
    return torch.einsum("...j,...ij->...i", x, y[..., index])


def sumvec_from_matrix(c: Tensor) -> Tensor:
    """Eq. (5): summary vector of a square matrix (last two axes). O(d^2)."""
    d = c.shape[-1]
    j = torch.arange(d, device=c.device)[None, :]  # row index
    # sumvec[i] = sum_j C[j, (i + j) mod d]
    return torch.sum(c[..., j, _cyclic(d, 1, c.device)], dim=-1)


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


def sumvec_direct(z1: Tensor, z2: Tensor, *, scale: Optional[float] = None) -> Tensor:
    """Eq. (10): sumvec via per-sample circular correlation. O(n d^2) oracle.

    ``z1, z2``: (n, d), in float32.  The samples are summed a chunk at a
    time, max(1, 2^26 // d^2) rows a chunk (the reference gathers all n at
    once).  The peak is the (d, d) int64 gather index, built once, plus one
    gathered (rows, d, d) f32 chunk of at most 256 MiB: 768 MiB at d = 8192.
    """
    z1, z2 = z1.float(), z2.float()
    d = z1.shape[-1]
    rows = max(1, _DIRECT_CHUNK_ELEMS // (d * d))
    index = _cyclic(d, 1, z1.device)
    sv = sum(
        torch.sum(_correlate(z1[k : k + rows], z2[k : k + rows], index), dim=0)
        for k in range(0, z1.shape[0], rows)
    )
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


def grouped_sumvec_fft(z1: Tensor, z2: Tensor, block_size: int, *, scale: Optional[float] = None) -> Tensor:
    """sumvec(C_ij) for every b x b block of C (§4.4). Returns (nb, nb, b)."""
    sv = torch.fft.irfft(grouped_frequency_accumulator(z1, z2, block_size), n=block_size, dim=-1)
    if scale is not None:
        sv = sv / scale
    return sv


def grouped_sumvec_from_matrix(c: Tensor, block_size: int) -> Tensor:
    """Oracle: zero-pad a full matrix C to a multiple of b, blockify it and
    sumvec each block. Returns (nb, nb, b)."""
    rem = (-c.shape[-1]) % block_size
    if rem:
        c = F.pad(c, (0, rem, 0, rem))
    nb = c.shape[-1] // block_size
    blocks = c.reshape(nb, block_size, nb, block_size).permute(0, 2, 1, 3)
    return sumvec_from_matrix(blocks)


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
