"""The decorrelation engine, ``local`` mode (port of ``repro/decorr/engine.py``).

Owns, for every ``DecorrConfig``: normalization (standardize for BT-style,
center for VICReg-style), the per-step feature permutation (explicit
indices; see ``core/permutation.py``), impl routing (the tensor's device
picks kernels or the plain route; ``use_kernel`` pins kernels) and scale
bookkeeping (n vs n - 1).  The ``global`` and ``tp`` modes belong to the
distributed slice of the port and raise here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import permutation as perm_lib
from repro_torch.core import regularizers as regs
from repro_torch.decorr.config import DecorrConfig

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
        if cfg.use_kernel:
            raise NotImplementedError(
                "the fused R_off kernel (xcorr_offdiag) belongs to the training "
                "slice of the port; use use_kernel=False for the matrix route"
            )
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
    impl: Optional[str] = None,
) -> Tensor:
    """Impl-routed decorrelating term R(C) in ``local`` mode.

    ``scale`` is the normalizer of C (n or n - 1).  The permutation is
    applied inside — callers must NOT pre-permute.  ``impl`` overrides the
    route (see ``core/regularizers.py``).
    """
    effective_mode(cfg)
    return _local_regularizer(z1, z2, cfg, float(scale), perm, impl)
