"""Decorrelating regularizers, port of ``repro/core/regularizers.py``.

Baselines (paper §3): ``r_off`` — the off-diagonal penalty, Eq. (2),
O(n d^2); ``r_var`` — the VICReg variance hinge, Eq. (4), O(n d).
Proposed (paper §4): ``r_sum`` — Eq. (6), O(n d log d); ``r_sum_grouped`` —
Eq. (13) with block size b.  For q = 2 the sums of squares are taken in the
frequency domain (Parseval); q = 1 needs the inverse transform.  The oracle
forms ``r_sum_from_matrix`` / ``r_sum_grouped_from_matrix`` take an explicit
C (any device) and do all their work in plain PyTorch on C's device.

Route choice (``impl``):
  * ``None``     — ``repro_torch.tune.best_impl(op, device)``: from the
                   tensor's device, a CUDA tensor takes the kernel pipelines
                   (``kernels/sumvec_fft``, ``kernels/grouped_sumvec``), a
                   CPU tensor the plain ``torch.fft`` route, unless an
                   ``override(op, impl=...)`` pins one;
  * ``"kernel"`` — the kernel pipelines (on a CPU tensor each kernel runs its
                   plain version; the tests use this);
  * ``"plain"``  — the ``torch.fft`` route on any device (the smoke's
                   on-card comparison).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import sumvec as sv
from repro_torch.kernels.grouped_sumvec import ops as gops
from repro_torch.kernels.sumvec_fft import ops as fops
from repro_torch.tune import dispatch as tune_dispatch

Tensor = torch.Tensor
IMPLS = ("kernel", "plain")


def r_off(m: Tensor) -> Tensor:
    """Eq. (2): sum of squared off-diagonal elements."""
    m = m.float()
    return torch.sum(m**2) - torch.sum(torch.diagonal(m) ** 2)


def r_var(m: Tensor, gamma: float = 1.0, eps: float = 1e-4) -> Tensor:
    """Eq. (4): hinge on per-feature standard deviation (diagonal of K)."""
    std = torch.sqrt(torch.clamp(torch.diagonal(m).float(), min=0.0) + eps)
    return torch.sum(torch.relu(gamma - std))


def r_var_from_embeddings(z: Tensor, gamma: float = 1.0, eps: float = 1e-4) -> Tensor:
    """Variance hinge straight from (n, d) embeddings — O(n d)."""
    std = torch.sqrt(torch.var(z.float(), dim=0, correction=1) + eps)
    return torch.sum(torch.relu(gamma - std))


def cross_correlation_matrix(z1: Tensor, z2: Tensor, scale: Optional[float] = None) -> Tensor:
    """C = (1/scale) Z1^T Z2 — caller standardizes/centers first. O(n d^2)."""
    n = z1.shape[0]
    c = z1.float().T @ z2.float()
    return c / (n if scale is None else scale)


def _resolve_impl(op: str, z: Tensor, q: int, impl: Optional[str]) -> str:
    if q not in (1, 2):
        raise ValueError(f"q must be 1 or 2, got {q!r}")
    if impl is None:
        impl = tune_dispatch.best_impl(op, z.device)
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


def r_sum_from_sumvec(svec: Tensor, q: int) -> Tensor:
    """Eq. (6) given a precomputed summary vector (drops component 0)."""
    tail = svec[..., 1:]
    if q == 1:
        return torch.sum(torch.abs(tail))
    return torch.sum(tail**2)


def r_sum(
    z1: Tensor,
    z2: Tensor,
    *,
    q: int = 2,
    scale: Optional[float] = None,
    impl: Optional[str] = None,
) -> Tensor:
    """Eq. (6) via FFT directly from the (n, d) embeddings.

    ``scale``: normalizer s of C (n or n-1).  ``impl`` as in the module doc.
    """
    d = z1.shape[-1]
    s = 1.0 if scale is None else float(scale)
    if _resolve_impl("r_sum", z1, q, impl) == "kernel":
        return fops.r_sum_fourstep(z1, z2, q=q, scale=s)
    if q == 2:
        # Parseval path — no inverse FFT
        g = sv.frequency_accumulator(z1, z2) / s
        sq, s0 = sv.sq_sum_and_zeroth_from_freq(g, d)
        return sq - s0**2
    return r_sum_from_sumvec(sv.sumvec_fft(z1, z2, scale=s), q)


def r_sum_grouped(
    z1: Tensor,
    z2: Tensor,
    block_size: int,
    *,
    q: int = 2,
    scale: Optional[float] = None,
    impl: Optional[str] = None,
) -> Tensor:
    """Eq. (13): grouped summary regularizer with block size b.

    Diagonal blocks drop their component 0 (the trace entries of C);
    off-diagonal blocks keep all b components.
    """
    b = int(block_size)
    s = 1.0 if scale is None else float(scale)
    impl = _resolve_impl("r_sum_grouped", z1, q, impl)
    # b > d means "pad d up to b" here (matching the matrix oracle), but the
    # kernel pipeline clamps b to d — the degenerate case takes the plain
    # route on every device so the loss never depends on the hardware.
    if impl == "kernel" and b <= z1.shape[-1]:
        return gops.r_sum_kernel(z1, z2, block_size=b, q=q, scale=s)
    g = sv.grouped_frequency_accumulator(z1, z2, b) / s  # (nb, nb, nf)
    eye = torch.eye(g.shape[0], dtype=torch.float32, device=g.device)
    if q == 2:
        sq, s0 = sv.sq_sum_and_zeroth_from_freq(g, b)  # (nb, nb) each
        return torch.sum(sq) - torch.sum(eye * s0**2)
    svec = torch.fft.irfft(g, n=b, dim=-1)  # (nb, nb, b)
    full = torch.sum(torch.abs(svec), dim=-1)  # includes component 0
    return torch.sum(full) - torch.sum(eye * torch.abs(svec[..., 0]))


def r_sum_auto(
    z1: Tensor,
    z2: Tensor,
    *,
    q: int = 2,
    block_size: Optional[int] = None,
    scale: Optional[float] = None,
    impl: Optional[str] = None,
) -> Tensor:
    """Grouped / ungrouped dispatch (b = None or b >= d ==> Eq. 6).

    The degenerate b <= 1 matrix route ignores ``impl``.
    """
    d = z1.shape[-1]
    if block_size is None or block_size >= d:
        return r_sum(z1, z2, q=q, scale=scale, impl=impl)
    if block_size <= 1:
        # R_sum^(1) with q=2 is exactly R_off (paper §4.4); the matrix route
        # keeps fidelity at this degenerate setting.
        c = cross_correlation_matrix(z1, z2, scale=scale)
        if q == 2:
            return r_off(c)
        return torch.sum(torch.abs(c)) - torch.sum(torch.abs(torch.diagonal(c)))
    return r_sum_grouped(z1, z2, block_size, q=q, scale=scale, impl=impl)


# ---------------------------------------------------------------------------
# Oracle forms (tests, the smoke's on-card check, baselines)
# ---------------------------------------------------------------------------


def r_sum_from_matrix(c: Tensor, q: int = 2) -> Tensor:
    """Eq. (6) by explicitly building sumvec(C) from the matrix."""
    return r_sum_from_sumvec(sv.sumvec_from_matrix(c), q)


def r_sum_grouped_from_matrix(c: Tensor, block_size: int, q: int = 2) -> Tensor:
    """Eq. (13) from an explicit matrix (oracle)."""
    blocks = sv.grouped_sumvec_from_matrix(c, block_size)  # (nb, nb, b)
    vals = torch.abs(blocks) if q == 1 else blocks**2
    eye = torch.eye(blocks.shape[0], dtype=vals.dtype, device=vals.device)
    return torch.sum(vals) - torch.sum(eye * vals[..., 0])
