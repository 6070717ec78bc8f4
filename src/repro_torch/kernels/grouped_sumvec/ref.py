"""Plain-torch oracle for the grouped sumvec regularizer (port of
``repro/kernels/grouped_sumvec/ref.py``).

Independent of ``repro_torch.core``: builds C = (1/scale) Z1^T Z2, takes
every b x b block's summary vector by explicit wrapped-diagonal sums (paper
Eq. 5), and evaluates Eq. 13 term by term.  O(n d^2) — validation only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _sumvec_matrix(c):
    """Summary vectors of the trailing (b, b) matrices of c."""
    b = c.shape[-1]
    i = torch.arange(b, device=c.device)[:, None]
    j = torch.arange(b, device=c.device)[None, :]
    cols = (i + j) % b
    return torch.sum(c[..., j, cols], dim=-1)


def grouped_sumvec_ref(z1, z2, block_size, scale=1.0):
    """Returns (nb, nb, b) time-domain summary vectors of every block."""
    d = z1.shape[1]
    rem = (-d) % block_size
    z1 = F.pad(z1.float(), (0, rem))
    z2 = F.pad(z2.float(), (0, rem))
    c = (z1.T @ z2) / scale
    nb = c.shape[-1] // block_size
    blocks = c.reshape(nb, block_size, nb, block_size).permute(0, 2, 1, 3)
    return _sumvec_matrix(blocks)


def r_sum_grouped_ref(z1, z2, block_size, q=2, scale=1.0):
    """Eq. (13) from the explicit matrix route."""
    sv = grouped_sumvec_ref(z1, z2, block_size, scale)
    vals = torch.abs(sv) if q == 1 else sv**2
    return torch.sum(vals) - torch.sum(torch.diagonal(vals[..., 0]))


def r_sum_ref(z1, z2, q=2, scale=1.0):
    """Ungrouped Eq. (6) oracle (single block of size d)."""
    c = (z1.float().T @ z2.float()) / scale
    tail = _sumvec_matrix(c)[1:]
    return torch.sum(torch.abs(tail)) if q == 1 else torch.sum(tail**2)
