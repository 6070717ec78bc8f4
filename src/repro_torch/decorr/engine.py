"""The decorrelation engine, ``local`` mode (port of ``repro/decorr/engine.py``).

``apply(z1, z2, cfg, perm)`` (and the style-specific ``barlow_twins`` /
``vicreg``) own, for every ``DecorrConfig``: normalization (standardize for
BT-style, center for VICReg-style), the per-step feature permutation
(explicit indices; see ``core/permutation.py``), impl routing (the tensor's
device picks kernels or the plain route; ``use_kernel`` pins kernels, and
for ``reg="off"`` selects the fused ``xcorr_offdiag`` kernel) and scale
bookkeeping (n vs n - 1).  Every route is differentiable: the kernels carry
their own vjps.  The ``global`` and ``tp`` modes belong to the distributed
slice of the port and raise here.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import permutation as perm_lib
from repro_torch.core import regularizers as regs
from repro_torch.decorr.config import DecorrConfig
from repro_torch.kernels.xcorr_offdiag import ops as xops

Tensor = torch.Tensor


def effective_mode(cfg: DecorrConfig) -> str:
    """'local' — the only mode this slice of the port runs."""
    mode = cfg.mode
    if mode != "local":
        raise NotImplementedError(
            f"DecorrConfig(distributed={cfg.distributed!r}) needs the distributed "
            "decorrelation slice of the port (torch.distributed global/tp modes), "
            "which is not ported yet; use distributed='local'"
        )
    return mode


def standardize(z: Tensor, cfg: DecorrConfig) -> Tensor:
    """Per-feature zero-mean unit-std over the batch (biased variance)."""
    z = z.float()
    zc = z - torch.mean(z, dim=0)
    var = torch.sum(zc * zc, dim=0) / z.shape[0]
    return zc / torch.sqrt(var + cfg.eps)


def center(z: Tensor, cfg: DecorrConfig) -> Tensor:
    """Per-feature zero-mean over the batch."""
    z = z.float()
    return z - torch.mean(z, dim=0)


def variance_hinge(z: Tensor, cfg: DecorrConfig, eps: float = 1e-4) -> Tensor:
    """VICReg Eq. (4) hinge from ddof-1 moments of the batch, summed over
    all features."""
    z = z.float()
    n = z.shape[0]
    zc = z - torch.mean(z, dim=0)
    var = torch.sum(zc * zc, dim=0) / max(n - 1.0, 1.0)
    return torch.sum(torch.relu(cfg.gamma - torch.sqrt(var + eps)))


def _maybe_permute(
    z1: Tensor, z2: Tensor, cfg: DecorrConfig, perm: Optional[Tensor]
) -> Tuple[Tensor, Tensor]:
    if cfg.permute and perm is not None and cfg.reg == "sum":
        return perm_lib.permute_views(perm, z1, z2)
    return z1, z2


def _impl(cfg: DecorrConfig, impl: Optional[str]) -> Optional[str]:
    # an explicit impl wins; else use_kernel pins kernels; None lets the
    # tensor's device decide
    if impl is not None:
        return impl
    return "kernel" if cfg.use_kernel else None


def _local_regularizer(
    z1: Tensor,
    z2: Tensor,
    cfg: DecorrConfig,
    scale: float,
    perm: Optional[Tensor],
    impl: Optional[str] = None,
) -> Tensor:
    if cfg.reg == "off":
        if impl != "plain" and (cfg.use_kernel or impl == "kernel"):
            return xops.off_diagonal_sq_sum(z1, z2, scale=scale)
        return regs.r_off(regs.cross_correlation_matrix(z1, z2, scale=scale))
    z1, z2 = _maybe_permute(z1, z2, cfg, perm)
    return regs.r_sum_auto(
        z1, z2, q=cfg.q, block_size=cfg.block_size, scale=scale, impl=_impl(cfg, impl)
    )


def regularizer(
    z1: Tensor,
    z2: Tensor,
    cfg: DecorrConfig,
    scale,
    perm: Optional[Tensor] = None,
    *,
    ddof: Optional[int] = None,
    impl: Optional[str] = None,
) -> Tensor:
    """Impl-routed decorrelating term R(C) in ``local`` mode.

    ``scale`` is the normalizer of C (n or n - 1).  ``ddof`` picks the exact
    effective-batch normalizer of the ``global`` / ``tp`` modes; in
    ``local`` mode the batch is the local one and ``scale`` already is that
    normalizer, so ``ddof`` changes nothing, as in the reference.  The
    permutation is applied inside — callers must NOT pre-permute.  ``impl``
    overrides the route (see ``core/regularizers.py``).
    """
    effective_mode(cfg)
    return _local_regularizer(z1, z2, cfg, float(scale), perm, impl)


# ---------------------------------------------------------------------------
# Full losses (paper Eq. 14 / Eq. 15), local mode
# ---------------------------------------------------------------------------


def barlow_twins(
    z1: Tensor,
    z2: Tensor,
    cfg: DecorrConfig,
    perm: Optional[Tensor] = None,
    *,
    impl: Optional[str] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Eq. (14): sum_i (1 - C_ii)^2 + lam * R(C) on standardized views."""
    cfg.validate()
    effective_mode(cfg)
    n = z1.shape[0]
    z1n = standardize(z1, cfg)
    z2n = standardize(z2, cfg)
    # diagonal (invariance) term: C_ii in O(n d)
    cii = torch.sum(z1n * z2n, dim=0) / n
    invariance = torch.sum((1.0 - cii) ** 2)
    reg = _local_regularizer(z1n, z2n, cfg, float(n), perm, impl)
    loss = invariance + cfg.lam * reg
    return loss, {"bt_invariance": invariance, "bt_reg": reg, "bt_loss": loss}


def vicreg(
    z1: Tensor,
    z2: Tensor,
    cfg: DecorrConfig,
    perm: Optional[Tensor] = None,
    *,
    impl: Optional[str] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Eq. (15): alpha MSE + (mu / d) R_var + (nu / d) R, the covariance
    regularizer of each view at scale n - 1."""
    cfg.validate()
    effective_mode(cfg)
    n, d = z1.shape
    z1, z2 = z1.float(), z2.float()
    # invariance: before centering (paper Eq. 3 uses raw embeddings)
    inv = torch.sum((z1 - z2) ** 2) / n
    var1 = variance_hinge(z1, cfg)
    var2 = variance_hinge(z2, cfg)
    c1 = center(z1, cfg)
    c2 = center(z2, cfg)
    scale = float(max(n - 1, 1))
    # each view against itself: ``c is c`` keeps one tensor, so the kernel
    # routes transform it once and autograd sums both operands' gradients
    reg1 = _local_regularizer(c1, c1, cfg, scale, perm, impl)
    reg2 = _local_regularizer(c2, c2, cfg, scale, perm, impl)
    loss = cfg.alpha * inv + (cfg.mu / d) * (var1 + var2) + (cfg.nu / d) * (reg1 + reg2)
    return loss, {
        "vic_invariance": inv,
        "vic_var": var1 + var2,
        "vic_reg": reg1 + reg2,
        "vic_loss": loss,
    }


def apply(
    z1: Tensor,
    z2: Tensor,
    cfg: DecorrConfig,
    perm: Optional[Tensor] = None,
    *,
    impl: Optional[str] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The engine entry point: full SSL loss for ``cfg.style``.

    ``perm``: this step's feature permutation (indices), applied inside to
    the R_sum family only.  ``impl`` overrides the regularizer route
    ("plain" on a CUDA tensor is how the smoke checks the kernel route).
    """
    if cfg.style == "bt":
        return barlow_twins(z1, z2, cfg, perm, impl=impl)
    return vicreg(z1, z2, cfg, perm, impl=impl)
