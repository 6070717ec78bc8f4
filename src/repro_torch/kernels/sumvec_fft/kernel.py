"""Four-step-FFT kernels for the ungrouped sumvec: ``cmatmul`` and ``ctwiddle``.

Port of ``repro/kernels/sumvec_fft/kernel.py`` (forward passes).  The CUDA
C++ sources are ``kernels/csrc/sumvec_fft.cu``, whose header note names the
TPU kernels they replace, their bound on an H100 and what the design does
about it.

Each kernel here has
  * a plain PyTorch version (``*_plain``), which the wrapper runs for CPU
    tensors, the CPU tests compare with the reference, and ``chip_smoke.py``
    compares the CUDA kernel with on the card;
  * a wrapper that checks device, dtype, shape and contiguity, launches on
    the current stream and raises on a launch error.  A CUDA tensor never
    falls back to the plain version;
  * a launch counter, ``<wrapper>.launches``, raised by one per CUDA launch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.utils import check_operand, route

Tensor = torch.Tensor
FAMILY = "sumvec_fft"


# ---------------------------------------------------------------------------
# cmatmul: (Ar + i Ai) @ (Br + i Bi) on real/imag planes
# ---------------------------------------------------------------------------


def cmatmul_plain(
    ar: Tensor, ai: Optional[Tensor], br: Tensor, bi: Tensor
) -> Tuple[Tensor, Tensor]:
    """Plain version of ``cmatmul``: four (two when Ai is None) real f32 products."""
    ar, br, bi = ar.float(), br.float(), bi.float()
    if ai is None:
        return ar @ br, ar @ bi
    ai = ai.float()
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def cmatmul(ar: Tensor, ai: Optional[Tensor], br: Tensor, bi: Tensor) -> Tuple[Tensor, Tensor]:
    """Complex matmul C = A @ B on (M, K) and (K, N) real/imag planes.

    ``ai=None`` means a real A (the four-step's first stage); the kernel then
    skips the two products with Ai.
    """
    if route(ar, ai, br, bi) == "cpu":
        return cmatmul_plain(ar, ai, br, bi)
    m, k = ar.shape
    n = br.shape[1]
    check_operand("cmatmul ar", ar, (m, k))
    if ai is not None:
        check_operand("cmatmul ai", ai, (m, k))
    check_operand("cmatmul br", br, (k, n))
    check_operand("cmatmul bi", bi, (k, n))
    cr = torch.empty((m, n), dtype=torch.float32, device=ar.device)
    ci = torch.empty_like(cr)
    if m and n:
        build.launch(FAMILY, "cmatmul", ar.device, ar, ai, br, bi, cr, ci, m, k, n)
        cmatmul.launches += 1
    return cr, ci


cmatmul.launches = 0


def rmatmul_complex_basis(x: Tensor, br: Tensor, bi: Tensor) -> Tuple[Tensor, Tensor]:
    """Real input times complex basis — cmatmul with Ai = 0 folded out."""
    return cmatmul(x, None, br, bi)


# ---------------------------------------------------------------------------
# ctwiddle: elementwise complex multiply by a constant plane
# ---------------------------------------------------------------------------


def ctwiddle_plain(xr: Tensor, xi: Tensor, wr: Tensor, wi: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain version of ``ctwiddle``: y = x o w, w broadcast over the rows."""
    xr, xi, wr, wi = xr.float(), xi.float(), wr.float(), wi.float()
    return xr * wr - xi * wi, xr * wi + xi * wr


def ctwiddle(xr: Tensor, xi: Tensor, wr: Tensor, wi: Tensor) -> Tuple[Tensor, Tensor]:
    """y = x o w (x: (n, d) complex pair, w: (d,) complex pair constant)."""
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
        ctwiddle.launches += 1
    return yr, yi


ctwiddle.launches = 0
