"""Plain-torch oracle for the four-step sumvec (port of
``repro/kernels/sumvec_fft/ref.py``).

Independent of ``repro_torch.core``: direct circular-correlation sums
(Appendix A), O(n d^2), and ``torch.fft`` spectra — for validation only.
"""

from __future__ import annotations

import torch


def sumvec_ref(z1, z2, scale=1.0):
    """sumvec(C) by direct O(n d^2) circular-correlation sums."""
    d = z1.shape[1]
    z1 = z1.float()
    z2 = z2.float()
    i = torch.arange(d, device=z1.device)[:, None]
    j = torch.arange(d, device=z1.device)[None, :]
    gather = (i + j) % d  # (d_out, d_in)
    # sum_k sum_j z1[k, j] * z2[k, (i + j) % d]
    return torch.einsum("kj,kij->i", z1, z2[:, gather]) / scale


def r_sum_ref(z1, z2, q=2, scale=1.0):
    """Eq. (6) from the direct summary vector."""
    sv = sumvec_ref(z1, z2, scale)
    tail = sv[1:]
    return torch.sum(torch.abs(tail)) if q == 1 else torch.sum(tail**2)


def spectrum_ref(x):
    """Full complex DFT of real rows (n, d) -> complex64 (n, d), natural order."""
    return torch.fft.fft(x.float(), dim=-1)
