"""Grouped-sumvec kernels: ``pmatmul``, ``freq_outer`` and ``freq_mat``.

Port of ``repro/kernels/grouped_sumvec/kernel.py``, forward and vjp.  The
CUDA C++ sources are ``kernels/csrc/grouped_sumvec.cu``, whose header note
names the TPU kernels they replace, their bound on an H100 and what the
design does about it.

Each kernel here has a plain PyTorch version (``*_plain``, run for CPU
tensors and compared with the kernel on the card), a launcher that checks
device, dtype, shape and contiguity, launches on the current stream and
raises on a launch error (a CUDA tensor never falls back), a
``torch.autograd.Function`` whose backward runs on the kernels as the
reference's ``custom_vjp``s do, and launch counters ``<wrapper>.launches``
/ ``.launches_bwd`` (``kernels.count_launch``):

  * ``pmatmul``:    dA = g @ B^T, dB = A^T @ g (two more pmatmuls; a
                    constant B — the DFT and synthesis bases — gets no
                    gradient, and its cached transpose comes in as ``b_t``);
  * ``freq_outer``: dA[f] = b[f] @ g[f]^T, dB[f] = a[f] @ g[f] (two
                    ``freq_mat``s);
  * ``freq_mat``:   dA[f] = g[f] @ m[f]^T (``freq_mat``), dM[f] = a[f]^T g[f]
                    (``freq_outer``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, count_launch
from repro_torch.kernels.utils import check_operand, route

Tensor = torch.Tensor
FAMILY = "grouped_sumvec"


# ---------------------------------------------------------------------------
# pmatmul: (M, K) @ (K, N) in f32
# ---------------------------------------------------------------------------


def pmatmul_plain(a: Tensor, b: Tensor) -> Tensor:
    """Plain version of ``pmatmul``: one f32 matrix product."""
    return a.float() @ b.float()


def _pmatmul_launch(a: Tensor, b: Tensor, *, bwd_owner=None) -> Tensor:
    if route(a, b) == "cpu":
        return pmatmul_plain(a, b)
    m, k = a.shape
    n = b.shape[1]
    check_operand("pmatmul a", a, (m, k))
    check_operand("pmatmul b", b, (k, n))
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m and n:
        if build.launch(FAMILY, "pmatmul", a.device, a, b, out, m, k, n):
            count_launch(pmatmul, bwd_owner)
    return out


class _PMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, b_t):
        ctx.save_for_backward(a, b, b_t)
        return _pmatmul_launch(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b, b_t = ctx.saved_tensors
        g = g.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            bt = b.T.contiguous() if b_t is None else b_t
            da = _pmatmul_launch(g, bt, bwd_owner=pmatmul)
        if ctx.needs_input_grad[1]:
            db = _pmatmul_launch(a.T.contiguous(), g, bwd_owner=pmatmul)
        return da, db, None


def pmatmul(a: Tensor, b: Tensor, b_t: Optional[Tensor] = None) -> Tensor:
    """f32 (M, K) @ (K, N).  ``b_t``: B^T, contiguous, for the vjp's dA
    (built on the fly when omitted)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"pmatmul: inner dims differ, {tuple(a.shape)} @ {tuple(b.shape)}")
    return _PMatmul.apply(a, b, b_t)


pmatmul.launches = 0
pmatmul.launches_bwd = 0


# ---------------------------------------------------------------------------
# freq_outer: G[f] = a[f]^T @ b[f]   (F, K, N) x (F, K, Nb) -> (F, N, Nb)
# ---------------------------------------------------------------------------


def freq_outer_plain(a: Tensor, b: Tensor) -> Tensor:
    """Plain version of ``freq_outer``: a batched a[f]^T @ b[f]."""
    return torch.matmul(a.float().transpose(1, 2), b.float())


def _freq_outer_launch(a: Tensor, b: Tensor, *, bwd_owner=None) -> Tensor:
    if route(a, b) == "cpu":
        return freq_outer_plain(a, b)
    f, k, n = a.shape
    nb = b.shape[2]
    check_operand("freq_outer a", a, (f, k, n))
    check_operand("freq_outer b", b, (f, k, nb))
    out = torch.empty((f, n, nb), dtype=torch.float32, device=a.device)
    if f and n and nb:
        if build.launch(FAMILY, "freq_outer", a.device, a, b, out, f, k, n, nb):
            count_launch(freq_outer, bwd_owner)
    return out


class _FreqOuter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _freq_outer_launch(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            # dA[f] = b[f] @ g[f]^T
            da = _freq_mat_launch(b, g.transpose(1, 2).contiguous(), bwd_owner=freq_outer)
        if ctx.needs_input_grad[1]:
            # dB[f] = a[f] @ g[f]
            db = _freq_mat_launch(a, g.contiguous(), bwd_owner=freq_outer)
        return da, db


def freq_outer(a: Tensor, b: Tensor) -> Tensor:
    """G[f] = a[f]^T @ b[f], reduced over the batch axis K."""
    if a.shape[:2] != b.shape[:2]:
        raise ValueError(f"freq_outer: (F, K) differ, {tuple(a.shape)} vs {tuple(b.shape)}")
    return _FreqOuter.apply(a, b)


freq_outer.launches = 0
freq_outer.launches_bwd = 0


# ---------------------------------------------------------------------------
# freq_mat: Y[f] = a[f] @ m[f]   (F, K, N) x (F, N, N2) -> (F, K, N2)
# ---------------------------------------------------------------------------


def freq_mat_plain(a: Tensor, m: Tensor) -> Tensor:
    """Plain version of ``freq_mat``: a batched a[f] @ m[f]."""
    return torch.matmul(a.float(), m.float())


def _freq_mat_launch(a: Tensor, m: Tensor, *, bwd_owner=None) -> Tensor:
    if route(a, m) == "cpu":
        return freq_mat_plain(a, m)
    f, k, n = a.shape
    n2 = m.shape[2]
    check_operand("freq_mat a", a, (f, k, n))
    check_operand("freq_mat m", m, (f, n, n2))
    out = torch.empty((f, k, n2), dtype=torch.float32, device=a.device)
    if f and k and n2:
        if build.launch(FAMILY, "freq_mat", a.device, a, m, out, f, k, n, n2):
            count_launch(freq_mat, bwd_owner)
    return out


class _FreqMat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, m):
        ctx.save_for_backward(a, m)
        return _freq_mat_launch(a, m)

    @staticmethod
    def backward(ctx, g):
        a, m = ctx.saved_tensors
        g = g.contiguous()
        da = dm = None
        if ctx.needs_input_grad[0]:
            da = _freq_mat_launch(g, m.transpose(1, 2).contiguous(), bwd_owner=freq_mat)
        if ctx.needs_input_grad[1]:
            dm = _freq_outer_launch(a, g, bwd_owner=freq_mat)
        return da, dm


def freq_mat(a: Tensor, m: Tensor) -> Tensor:
    """Y[f] = a[f] @ m[f]: (F, K, N) x (F, N, N2) -> (F, K, N2)."""
    if a.shape[0] != m.shape[0] or a.shape[2] != m.shape[1]:
        raise ValueError(f"freq_mat: shapes do not chain, {tuple(a.shape)} @ {tuple(m.shape)}")
    return _FreqMat.apply(a, m)


freq_mat.launches = 0
freq_mat.launches_bwd = 0
