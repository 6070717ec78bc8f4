"""Grouped-sumvec kernels: ``pmatmul`` and ``freq_outer`` (forward).

Port of ``repro/kernels/grouped_sumvec/kernel.py``.  The CUDA C++ sources
are ``kernels/csrc/grouped_sumvec.cu``, whose header note names the TPU
kernels they replace, their bound on an H100 and what the design does about
it.  ``freq_mat`` and the backward passes belong to the training slice.

Each kernel here has a plain PyTorch version (``*_plain``, run for CPU
tensors and compared with the kernel on the card), a wrapper that checks
device, dtype, shape and contiguity, launches on the current stream and
raises on a launch error (a CUDA tensor never falls back), and a launch
counter ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.utils import check_operand, route

Tensor = torch.Tensor
FAMILY = "grouped_sumvec"


# ---------------------------------------------------------------------------
# pmatmul: (M, K) @ (K, N) in f32
# ---------------------------------------------------------------------------


def pmatmul_plain(a: Tensor, b: Tensor) -> Tensor:
    """Plain version of ``pmatmul``: one f32 matrix product."""
    return a.float() @ b.float()


def pmatmul(a: Tensor, b: Tensor) -> Tensor:
    """f32 (M, K) @ (K, N)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"pmatmul: inner dims differ, {tuple(a.shape)} @ {tuple(b.shape)}")
    if route(a, b) == "cpu":
        return pmatmul_plain(a, b)
    m, k = a.shape
    n = b.shape[1]
    check_operand("pmatmul a", a, (m, k))
    check_operand("pmatmul b", b, (k, n))
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m and n:
        build.launch(FAMILY, "pmatmul", a.device, a, b, out, m, k, n)
        pmatmul.launches += 1
    return out


pmatmul.launches = 0


# ---------------------------------------------------------------------------
# freq_outer: G[f] = a[f]^T @ b[f]   (F, K, N) x (F, K, Nb) -> (F, N, Nb)
# ---------------------------------------------------------------------------


def freq_outer_plain(a: Tensor, b: Tensor) -> Tensor:
    """Plain version of ``freq_outer``: a batched a[f]^T @ b[f]."""
    return torch.matmul(a.float().transpose(1, 2), b.float())


def freq_outer(a: Tensor, b: Tensor) -> Tensor:
    """G[f] = a[f]^T @ b[f], reduced over the batch axis K."""
    if a.shape[:2] != b.shape[:2]:
        raise ValueError(f"freq_outer: (F, K) differ, {tuple(a.shape)} vs {tuple(b.shape)}")
    if route(a, b) == "cpu":
        return freq_outer_plain(a, b)
    f, k, n = a.shape
    nb = b.shape[2]
    check_operand("freq_outer a", a, (f, k, n))
    check_operand("freq_outer b", b, (f, k, nb))
    out = torch.empty((f, n, nb), dtype=torch.float32, device=a.device)
    if f and n and nb:
        build.launch(FAMILY, "freq_outer", a.device, a, b, out, f, k, n, nb)
        freq_outer.launches += 1
    return out


freq_outer.launches = 0
