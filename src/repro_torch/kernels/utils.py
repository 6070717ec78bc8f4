"""Shared kernel helpers: padding and the DFT bases the kernels multiply by.

Port of ``repro/kernels/pallas_utils.py``.  The TPU's (8, 128) tile padding
has no counterpart here: the CUDA kernels mask their ragged edges
themselves, so only the semantic padding (``pad_axis``, used by the padded
four-step plan and the grouped block split) remains.  The bases are built in
float64 numpy and rounded once to float32, exactly as the reference builds
them, so the two agree to the last bit; their conjugate transposes (for the
vjps) are cached beside them.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def next_multiple(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return ((x + m - 1) // m) * m


def pad_axis(x: Tensor, axis: int, target: int) -> Tensor:
    """Zero-pad ``axis`` of x up to length ``target``."""
    cur = x.shape[axis]
    if cur == target:
        return x
    axis = axis % x.ndim
    # F.pad lists (left, right) pairs from the LAST axis backwards
    pad = [0, 0] * (x.ndim - 1 - axis) + [0, target - cur]
    return F.pad(x, pad)


def _as_tensor(a: np.ndarray, device) -> Tensor:
    return torch.as_tensor(a.astype(np.float32), device=device)


# The bases below are constants of (d, device): each is built once and shared
# by every caller, which must treat it as read-only.
@functools.lru_cache(maxsize=64)
def dft_matrices(d: int, device=None) -> Tuple[Tensor, Tensor]:
    """Real/imag rfft basis: F[f] = sum_t z[t] * (Cr[t,f] + i Ci[t,f]).

    Cr[t, f] = cos(2 pi t f / d);  Ci[t, f] = -sin(2 pi t f / d).
    Shapes (d, d//2 + 1).
    """
    nf = d // 2 + 1
    t = np.arange(d)[:, None]
    f = np.arange(nf)[None, :]
    ang = 2.0 * np.pi * t * f / d
    return _as_tensor(np.cos(ang), device), _as_tensor(-np.sin(ang), device)


@functools.lru_cache(maxsize=64)
def full_dft_matrices(d: int, sign: int = -1, device=None) -> Tuple[Tensor, Tensor]:
    """Full complex DFT basis W[t, f] = exp(sign * 2 pi i t f / d) as (re, im)."""
    t = np.arange(d)[:, None]
    f = np.arange(d)[None, :]
    ang = 2.0 * np.pi * t * f / d * sign
    return _as_tensor(np.cos(ang), device), _as_tensor(np.sin(ang), device)


@functools.lru_cache(maxsize=64)
def full_dft_adjoint(d: int, sign: int = -1, device=None) -> Tuple[Tensor, Tensor]:
    """W^H of ``full_dft_matrices(d, sign, device)`` as contiguous (re, im)
    planes (Wr^T, -Wi^T): the operand of the cmatmul vjp's dA = g @ W^H."""
    wr, wi = full_dft_matrices(d, sign, device)
    return wr.T.contiguous(), (-wi).T.contiguous()


@functools.lru_cache(maxsize=64)
def irfft_basis(d: int, device=None) -> Tuple[Tensor, Tensor]:
    """Synthesis basis: s[t] = sum_f  Br[f, t] * Gr[f] + Bi[f, t] * Gi[f].

    Derived from s = irfft(G):  s[t] = (1/d) sum_f w_f (Gr cos(2pi ft/d)
    - Gi sin(2pi ft/d)), w_f the rfft duplication weights.
    Shapes (d//2+1, d).
    """
    nf = d // 2 + 1
    w = np.full((nf,), 2.0)
    w[0] = 1.0
    if d % 2 == 0:
        w[-1] = 1.0
    f = np.arange(nf)[:, None]
    t = np.arange(d)[None, :]
    ang = 2.0 * np.pi * f * t / d
    br = (w[:, None] * np.cos(ang)) / d
    bi = (-w[:, None] * np.sin(ang)) / d
    return _as_tensor(br, device), _as_tensor(bi, device)


def check_operand(name: str, x: Tensor, shape: Tuple[int, ...]) -> None:
    """Raise unless ``x`` is a contiguous float32 CUDA tensor of ``shape`` —
    the one layout every CUDA kernel of this package takes."""
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def route(*xs: Optional[Tensor]) -> str:
    """'cpu' or 'cuda' from the operands' devices; mixed or other devices raise."""
    kinds = {x.device.type for x in xs if x is not None}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"} and len({x.device for x in xs if x is not None}) == 1:
        return "cuda"
    raise ValueError(f"operands must all lie on the CPU or on one CUDA device, got {kinds}")
