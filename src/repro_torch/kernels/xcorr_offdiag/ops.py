"""Off-diagonal penalty: fused CUDA forward + Gram-trick backward.

Port of ``repro/kernels/xcorr_offdiag/ops.py``.  The gradient of R_off
never needs the d x d matrix either.  With C = (1/s) Z1^T Z2,

    dR/dZ1 = (2/s) Z2 (C - diag C)^T
           = (2/s^2) (Z2 Z2^T) Z1 - (2/s) Z2 * c_diag

— an n x n Gram matrix route costing O(n^2 d), a factor d/n cheaper than
the O(n d^2) matrix route whenever the batch is smaller than the width.
For n > d the matrix route is the cheaper one and is taken instead.  These
are plain products, which the reference also leaves outside its kernel.
The same identity gives an O(n^2 d) forward (``r_off_gram``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.xcorr_offdiag.kernel import off_diagonal_sq_sum_raw

Tensor = torch.Tensor


class _OffDiagSqSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z1, z2, scale):
        ctx.save_for_backward(z1, z2)
        ctx.scale = scale
        return off_diagonal_sq_sum_raw(z1, z2) / (scale * scale)

    @staticmethod
    def backward(ctx, g):
        z1, z2 = ctx.saved_tensors
        z1, z2 = z1.float(), z2.float()
        s = ctx.scale
        n, d = z1.shape
        if n <= d:
            c_diag = torch.sum(z1 * z2, dim=0) / s  # (d,)
            dz1 = (2.0 / s**2) * ((z2 @ z2.T) @ z1) - (2.0 / s) * z2 * c_diag
            dz2 = (2.0 / s**2) * ((z1 @ z1.T) @ z2) - (2.0 / s) * z1 * c_diag
        else:
            c = (z1.T @ z2) / s
            coff = c - torch.diag(torch.diagonal(c))
            dz1 = (2.0 / s) * (z2 @ coff.T)
            dz2 = (2.0 / s) * (z1 @ coff)
        return g * dz1, g * dz2, None


def off_diagonal_sq_sum(z1: Tensor, z2: Tensor, *, scale: Optional[float] = None) -> Tensor:
    """R_off(C) with C = (1/scale) Z1^T Z2 — fused kernel forward, Gram backward."""
    s = 1.0 if scale is None else float(scale)
    return _OffDiagSqSum.apply(z1, z2, s)


def r_off_gram(z1: Tensor, z2: Tensor, *, scale: Optional[float] = None) -> Tensor:
    """O(n^2 d) forward for R_off via Gram matrices (strengthened baseline).

    ||C||_F^2 = (1/s^2) tr(Z2^T Z1 Z1^T Z2) = (1/s^2) <Z1 Z1^T, Z2 Z2^T>.
    """
    s = 1.0 if scale is None else float(scale)
    z1, z2 = z1.float(), z2.float()
    fro = torch.sum((z1 @ z1.T) * (z2 @ z2.T)) / (s * s)
    c_diag = torch.sum(z1 * z2, dim=0) / s
    return fro - torch.sum(c_diag**2)
