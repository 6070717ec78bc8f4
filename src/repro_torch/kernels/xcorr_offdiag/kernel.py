"""The fused R_off kernel: ``off_diagonal_sq_sum_raw``.

Port of ``repro/kernels/xcorr_offdiag/kernel.py``.  The CUDA C++ source is
``kernels/csrc/xcorr_offdiag.cu``, whose header note names the TPU kernel it
replaces, its bound on an H100 and what the design does about it: the d x d
matrix C = Z1^T Z2 is formed in 128 x 128 tiles in registers from batch
slices staged through a ring in shared memory, squared, diagonal-masked and
folded into one partial per tile (``TILE``) that a second pass sums in a
fixed order.

Beside the kernel: a plain PyTorch version (``*_plain``, run for CPU tensors
and compared with the kernel on the card), a launcher that checks device,
dtype, shape and contiguity and raises on a launch error (a CUDA tensor
never falls back), and launch counters ``.launches`` / ``.launches_bwd``
(the backward pass is torch products, ``ops.py``, so ``launches_bwd`` stays
0).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, count_launch
from repro_torch.kernels.utils import check_operand, route

Tensor = torch.Tensor
FAMILY = "xcorr_offdiag"
TILE = 128  # the CUDA kernel's C tile edge: one partial per tile


def off_diagonal_sq_sum_plain(z1: Tensor, z2: Tensor) -> Tensor:
    """Plain version: materialize C = Z1^T Z2, square, drop the diagonal, sum."""
    c = z1.float().T @ z2.float()
    return torch.sum(c * c) - torch.sum(torch.diagonal(c) ** 2)


def off_diagonal_sq_sum_raw(z1: Tensor, z2: Tensor) -> Tensor:
    """sum_{i != j} (Z1^T Z2)_ij^2 as a 0-d f32 tensor, without the d x d
    matrix in device memory.  ``z1, z2``: (n, d)."""
    if z1.shape != z2.shape or z1.dim() != 2:
        raise ValueError(f"xcorr_offdiag: expected two (n, d) views, got {tuple(z1.shape)}, {tuple(z2.shape)}")
    if route(z1, z2) == "cpu":
        return off_diagonal_sq_sum_plain(z1, z2)
    n, d = z1.shape
    check_operand("xcorr_offdiag z1", z1, (n, d))
    check_operand("xcorr_offdiag z2", z2, (n, d))
    out = torch.zeros((), dtype=torch.float32, device=z1.device)
    if n and d:
        tiles = -(-d // TILE)
        partial = torch.empty((tiles * tiles,), dtype=torch.float32, device=z1.device)
        if build.launch(FAMILY, "off_diagonal_sq_sum", z1.device, z1, z2, partial, out, n, d):
            count_launch(off_diagonal_sq_sum_raw)
    return out


off_diagonal_sq_sum_raw.launches = 0
off_diagonal_sq_sum_raw.launches_bwd = 0
