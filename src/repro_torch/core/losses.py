"""Full SSL loss functions (paper §3, §4.6), port of ``repro/core/losses.py``.

* ``barlow_twins_loss`` — Eq. (14): invariance on the diagonal + lambda * R
* ``vicreg_loss``       — Eq. (15): alpha MSE + mu R_var + nu R
with R in {R_off (baseline), R_sum, R_sum^(b)} selected by ``DecorrConfig``.

All routing (normalization, permutation, kernel vs plain route, scale
bookkeeping) lives in ``repro_torch.decorr.engine``; this module keeps the
reference's import surface plus the paper's evaluation metrics (Eq. 16 /
17).  ``perm`` is this step's feature permutation as explicit indices (the
reference takes a PRNG key; see ``core/permutation.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import regularizers as regs
from repro_torch.decorr import engine as _engine
from repro_torch.decorr.config import DecorrConfig

Tensor = torch.Tensor
LossOut = Tuple[Tensor, Dict[str, Tensor]]


def standardize(z: Tensor, eps: float = 1e-5) -> Tensor:
    """Per-feature zero-mean unit-std over the batch (BT preprocessing)."""
    z = z.float()
    mean = torch.mean(z, dim=0, keepdim=True)
    var = torch.var(z, dim=0, keepdim=True, correction=0)
    return (z - mean) / torch.sqrt(var + eps)


def center(z: Tensor) -> Tensor:
    """Per-feature zero-mean over the batch (VICReg preprocessing)."""
    z = z.float()
    return z - torch.mean(z, dim=0, keepdim=True)


def barlow_twins_loss(
    z1: Tensor, z2: Tensor, cfg: DecorrConfig, perm: Optional[Tensor] = None, *, impl: Optional[str] = None
) -> LossOut:
    """Eq. (14). Returns (loss, metrics). ``z1, z2``: raw (n, d) projections."""
    return _engine.barlow_twins(z1, z2, cfg, perm, impl=impl)


def vicreg_loss(
    z1: Tensor, z2: Tensor, cfg: DecorrConfig, perm: Optional[Tensor] = None, *, impl: Optional[str] = None
) -> LossOut:
    """Eq. (15). Returns (loss, metrics)."""
    return _engine.vicreg(z1, z2, cfg, perm, impl=impl)


def ssl_loss(
    z1: Tensor, z2: Tensor, cfg: DecorrConfig, perm: Optional[Tensor] = None, *, impl: Optional[str] = None
) -> LossOut:
    """Dispatch on cfg.style."""
    return _engine.apply(z1, z2, cfg, perm, impl=impl)


# ---------------------------------------------------------------------------
# The paper's evaluation metrics (Eq. 16 / 17): decorrelation quality probes
# ---------------------------------------------------------------------------


def normalized_bt_regularizer(z1: Tensor, z2: Tensor, eps: float = 1e-5) -> Tensor:
    """Eq. (16): R_off(C(A, B)) / (d (d - 1)) on standardized views."""
    d = z1.shape[-1]
    c = regs.cross_correlation_matrix(standardize(z1, eps), standardize(z2, eps))
    return regs.r_off(c) / (d * (d - 1))


def normalized_vic_regularizer(z1: Tensor, z2: Tensor) -> Tensor:
    """Eq. (17): (R_off(K(A)) + R_off(K(B))) / (2 d (d - 1))."""
    n, d = z1.shape
    k1 = regs.cross_correlation_matrix(center(z1), center(z1), scale=max(n - 1, 1))
    k2 = regs.cross_correlation_matrix(center(z2), center(z2), scale=max(n - 1, 1))
    return (regs.r_off(k1) + regs.r_off(k2)) / (2 * d * (d - 1))
