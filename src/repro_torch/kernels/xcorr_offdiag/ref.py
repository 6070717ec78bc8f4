"""Plain-torch oracle for the fused off-diagonal kernel (port of
``repro/kernels/xcorr_offdiag/ref.py``): materialize C, square, mask the
diagonal, sum."""

from __future__ import annotations

import torch


def off_diagonal_sq_sum_ref(z1, z2, scale=1.0):
    """R_off of C = (1/scale) Z1^T Z2 through the explicit d x d matrix."""
    c = (z1.float().T @ z2.float()) / scale
    sq = c * c
    return torch.sum(sq) - torch.sum(torch.diagonal(sq))
