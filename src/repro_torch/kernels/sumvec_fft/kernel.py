"""Four-step-FFT kernels for the ungrouped sumvec: ``cmatmul`` and ``ctwiddle``.

Port of ``repro/kernels/sumvec_fft/kernel.py``, forward and vjp.  The CUDA
C++ sources are ``kernels/csrc/sumvec_fft.cu``, whose header note names the
TPU kernels they replace, their bound on an H100 and what the design does
about it.

Each kernel here has
  * a plain PyTorch version (``*_plain``), which the launcher runs for CPU
    tensors, the CPU tests compare with the reference, and ``chip_smoke.py``
    compares the CUDA kernel with on the card;
  * a launcher that checks device, dtype, shape and contiguity, launches on
    the current stream and raises on a launch error.  A CUDA tensor never
    falls back to the plain version;
  * a ``torch.autograd.Function`` whose backward is the same kernel again,
    as the reference's ``custom_vjp`` is: ``cmatmul(g, B^H)`` and
    ``ctwiddle(g, conj w)``.  The constant bases and twiddles get no
    gradient unless they require one, and their conjugates come in cached
    (``bh`` / ``w_conj``) so a backward pass copies nothing;
  * launch counters ``<wrapper>.launches`` / ``.launches_bwd``
    (``kernels.count_launch``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, count_launch
from repro_torch.kernels.utils import check_operand, route

Tensor = torch.Tensor
FAMILY = "sumvec_fft"
Pair = Tuple[Tensor, Tensor]


# ---------------------------------------------------------------------------
# cmatmul: (Ar + i Ai) @ (Br + i Bi) on real/imag planes
# ---------------------------------------------------------------------------


def cmatmul_plain(ar: Tensor, ai: Optional[Tensor], br: Tensor, bi: Tensor) -> Pair:
    """Plain version of ``cmatmul``: four (two when Ai is None) real f32 products."""
    ar, br, bi = ar.float(), br.float(), bi.float()
    if ai is None:
        return ar @ br, ar @ bi
    ai = ai.float()
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def _cmatmul_launch(ar, ai, br, bi, *, real_out: bool = False, bwd_owner=None):
    """C = A @ B on the operands' device; ``real_out`` computes Re C only
    (returned as (Cr, None))."""
    if route(ar, ai, br, bi) == "cpu":
        if real_out:
            ai_bi = 0.0 if ai is None else ai.float() @ bi.float()
            return ar.float() @ br.float() - ai_bi, None
        return cmatmul_plain(ar, ai, br, bi)
    m, k = ar.shape
    n = br.shape[1]
    check_operand("cmatmul ar", ar, (m, k))
    if ai is not None:
        check_operand("cmatmul ai", ai, (m, k))
    check_operand("cmatmul br", br, (k, n))
    check_operand("cmatmul bi", bi, (k, n))
    cr = torch.empty((m, n), dtype=torch.float32, device=ar.device)
    ci = None if real_out else torch.empty_like(cr)
    if m and n:
        build.launch(FAMILY, "cmatmul", ar.device, ar, ai, br, bi, cr, ci, m, k, n)
        count_launch(cmatmul, bwd_owner)
    return cr, ci


def _adjoint(br: Tensor, bi: Tensor) -> Pair:
    """B^H = (Br^T, -Bi^T), contiguous (a copy; callers on the hot path
    pass the cached one)."""
    return br.T.contiguous(), (-bi).T.contiguous()


class _CMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ar, ai, br, bi, bhr, bhi):
        cr, ci = _cmatmul_launch(ar, ai, br, bi)
        ctx.save_for_backward(ar, ai, br, bi, bhr, bhi)
        return cr, ci

    @staticmethod
    def backward(ctx, gr, gi):
        ar, ai, br, bi, bhr, bhi = ctx.saved_tensors
        gr, gi = gr.contiguous(), gi.contiguous()
        need = ctx.needs_input_grad
        dar = dai = dbr = dbi = None
        if need[0] or need[1]:
            # dA = g @ B^H; a real A (the four-step's first stage) needs Re dA only
            if bhr is None:
                bhr, bhi = _adjoint(br, bi)
            dar, dai = _cmatmul_launch(gr, gi, bhr, bhi, real_out=ai is None, bwd_owner=cmatmul)
        if need[2] or need[3]:
            # dB = A^H @ g
            air = None if ai is None else (-ai).T.contiguous()
            dbr, dbi = _cmatmul_launch(ar.T.contiguous(), air, gr, gi, bwd_owner=cmatmul)
        return dar, dai, dbr, dbi, None, None


def cmatmul(
    ar: Tensor, ai: Optional[Tensor], br: Tensor, bi: Tensor, bh: Optional[Pair] = None
) -> Pair:
    """Complex matmul C = A @ B on (M, K) and (K, N) real/imag planes.

    ``ai=None`` means a real A (the four-step's first stage); the kernel then
    skips the two products with Ai.  ``bh``: B's conjugate transpose
    (Br^T, -Bi^T) as contiguous planes, for the vjp's dA = g @ B^H; built on
    the fly when omitted.
    """
    bhr, bhi = (None, None) if bh is None else bh
    return _CMatmul.apply(ar, ai, br, bi, bhr, bhi)


cmatmul.launches = 0
cmatmul.launches_bwd = 0


def rmatmul_complex_basis(x: Tensor, br: Tensor, bi: Tensor, bh: Optional[Pair] = None) -> Pair:
    """Real input times complex basis — cmatmul with Ai = 0 folded out."""
    return cmatmul(x, None, br, bi, bh)


# ---------------------------------------------------------------------------
# ctwiddle: elementwise complex multiply by a constant plane
# ---------------------------------------------------------------------------


def ctwiddle_plain(xr: Tensor, xi: Tensor, wr: Tensor, wi: Tensor) -> Pair:
    """Plain version of ``ctwiddle``: y = x o w, w broadcast over the rows."""
    xr, xi, wr, wi = xr.float(), xi.float(), wr.float(), wi.float()
    return xr * wr - xi * wi, xr * wi + xi * wr


def _ctwiddle_launch(xr, xi, wr, wi, *, bwd_owner=None) -> Pair:
    if route(xr, xi, wr, wi) == "cpu":
        return ctwiddle_plain(xr, xi, wr, wi)
    n, d = xr.shape
    check_operand("ctwiddle xr", xr, (n, d))
    check_operand("ctwiddle xi", xi, (n, d))
    check_operand("ctwiddle wr", wr, (d,))
    check_operand("ctwiddle wi", wi, (d,))
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    if n and d:
        build.launch(FAMILY, "ctwiddle", xr.device, xr, xi, wr, wi, yr, yi, n, d)
        count_launch(ctwiddle, bwd_owner)
    return yr, yi


class _CTwiddle(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xr, xi, wr, wi, wcr, wci):
        yr, yi = _ctwiddle_launch(xr, xi, wr, wi)
        ctx.save_for_backward(xr, xi, wr, wi, wcr, wci)
        return yr, yi

    @staticmethod
    def backward(ctx, gr, gi):
        xr, xi, wr, wi, wcr, wci = ctx.saved_tensors
        gr, gi = gr.contiguous(), gi.contiguous()
        need = ctx.needs_input_grad
        dxr = dxi = dwr = dwi = None
        if need[0] or need[1]:
            # dx = g o conj(w)
            if wcr is None:
                wcr, wci = wr, (-wi).contiguous()
            dxr, dxi = _ctwiddle_launch(gr, gi, wcr, wci, bwd_owner=ctwiddle)
        if need[2] or need[3]:
            # dw = sum_k conj(x_k) o g_k
            dwr = torch.sum(xr * gr + xi * gi, dim=0)
            dwi = torch.sum(xr * gi - xi * gr, dim=0)
        return dxr, dxi, dwr, dwi, None, None


def ctwiddle(
    xr: Tensor, xi: Tensor, wr: Tensor, wi: Tensor, w_conj: Optional[Pair] = None
) -> Pair:
    """y = x o w (x: (n, d) complex pair, w: (d,) complex pair constant).

    ``w_conj``: conj(w) = (wr, -wi) as contiguous planes, for the vjp;
    built on the fly when omitted.
    """
    wcr, wci = (None, None) if w_conj is None else w_conj
    return _CTwiddle.apply(xr, xi, wr, wi, wcr, wci)


ctwiddle.launches = 0
ctwiddle.launches_bwd = 0
