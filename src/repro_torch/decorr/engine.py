"""The decorrelation engine (port of ``repro/decorr/engine.py``).

``apply(z1, z2, cfg, perm)`` (and the style-specific ``barlow_twins`` /
``vicreg``) own, for every ``DecorrConfig``:

  * normalization — standardize (BT) / center (VICReg) with shard-local
    moments in ``local`` mode and all-reduced global-batch moments in
    ``global`` / ``tp`` mode (two O(d) all-reduces: mean, then centered
    variance);
  * feature permutation — explicit indices (see ``core/permutation.py``),
    the same on every rank; in ``tp`` mode applied to the full-feature rows
    *after* the all-to-all transpose, so it equals the permutation one
    device applies to the unsharded d;
  * mode routing — ``local | global | tp`` (see ``decorr/modes.py``), with
    ``tp`` refusing to run without a ``model_axis`` instead of silently
    computing the shard-local loss;
  * impl routing — the tensor's device picks kernels or the plain route;
    ``use_kernel`` pins kernels (for ``reg="off"`` in ``local`` mode, the
    fused ``xcorr_offdiag`` kernel); ``impl=`` overrides every route;
  * scale bookkeeping — n vs n - 1, local vs effective global batch, full
    vs shard-local feature width.

Every route is differentiable: the kernels carry their own vjps and the
collectives differentiate as under JAX's ``shard_map`` (``decorr/modes.py``).
The ``global`` / ``tp`` modes run on each rank of a mesh installed with
``parallel.sharding.sharding_context``; ``cfg.axis_name`` / ``model_axis``
name its axes (e.g. ``train/ssl.make_sharded_ssl_train_step``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import permutation as perm_lib
from repro_torch.core import regularizers as regs
from repro_torch.decorr import modes
from repro_torch.decorr.config import DecorrConfig
from repro_torch.kernels.xcorr_offdiag import ops as xops

Tensor = torch.Tensor


def effective_mode(cfg: DecorrConfig) -> str:
    """'local' | 'global' | 'tp' — with the tp misconfiguration rejected.

    ``global`` with no ``axis_name`` is the local computation, so it degrades
    quietly.  ``tp`` with no ``model_axis`` would silently compute the wrong
    (shard-local) loss, so it raises instead.
    """
    if cfg.distributed == "tp" and cfg.model_axis is None:
        raise ValueError(
            "DecorrConfig(distributed='tp') requires model_axis (the mesh axis "
            "the feature dim is sharded over); refusing to fall back to the "
            "shard-local loss. Set model_axis or use distributed='local'/'global'."
        )
    return cfg.mode


def _batch_axis(cfg: DecorrConfig, mode: str) -> Optional[str]:
    return cfg.axis_name if mode in ("global", "tp") else None


# ---------------------------------------------------------------------------
# Normalization + moment statistics (local vs all-reduced global moments)
# ---------------------------------------------------------------------------


def _row_moment(total: Tensor, batch_axis: Optional[str], n: float) -> Tensor:
    """A per-feature moment from this rank's column sums, all-reduced over
    the batch axis, that this rank's rows are then normalized by: marked
    with ``pvary_if``, so every rank's share of its cotangent is summed."""
    return modes.pvary_if(modes.psum_if(total, batch_axis), batch_axis) / n


def _mean_and_n(z: Tensor, batch_axis: Optional[str]) -> Tuple[Tensor, float]:
    z = z.float()
    n = modes.effective_batch(z.shape[0], batch_axis)
    return _row_moment(torch.sum(z, dim=0), batch_axis, n), n


def standardize(z: Tensor, cfg: DecorrConfig, mode: Optional[str] = None) -> Tensor:
    """Per-feature zero-mean unit-std over the (mode-effective) batch
    (biased variance)."""
    batch_axis = _batch_axis(cfg, mode or effective_mode(cfg))
    mean, n = _mean_and_n(z, batch_axis)
    zc = z.float() - mean
    var = _row_moment(torch.sum(zc * zc, dim=0), batch_axis, n)
    return zc / torch.sqrt(var + cfg.eps)


def center(z: Tensor, cfg: DecorrConfig, mode: Optional[str] = None) -> Tensor:
    """Per-feature zero-mean over the (mode-effective) batch."""
    batch_axis = _batch_axis(cfg, mode or effective_mode(cfg))
    mean, _ = _mean_and_n(z, batch_axis)
    return z.float() - mean


def variance_hinge(z: Tensor, cfg: DecorrConfig, mode: Optional[str] = None, eps: float = 1e-4) -> Tensor:
    """VICReg Eq. (4) hinge from ddof-1 moments of the effective batch,
    summed over ALL features (all-reduced over the model axis in tp mode)."""
    mode = mode or effective_mode(cfg)
    batch_axis = _batch_axis(cfg, mode)
    mean, n = _mean_and_n(z, batch_axis)
    zc = z.float() - mean
    var = modes.psum_if(torch.sum(zc * zc, dim=0), batch_axis) / max(n - 1.0, 1.0)
    hinge = torch.sum(torch.relu(cfg.gamma - torch.sqrt(var + eps)))
    if mode == "tp":
        hinge = modes.psum_if(hinge, cfg.model_axis)
    return hinge


# ---------------------------------------------------------------------------
# Regularizer routing (mode x impl x grouped/ungrouped x q)
# ---------------------------------------------------------------------------


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


def _global_regularizer(
    z1: Tensor,
    z2: Tensor,
    cfg: DecorrConfig,
    total_scale: float,
    perm: Optional[Tensor],
    impl: Optional[str] = None,
) -> Tensor:
    if cfg.reg == "off":
        return modes.r_off_global(z1, z2, axis_name=cfg.axis_name, total_scale=total_scale)
    z1, z2 = _maybe_permute(z1, z2, cfg, perm)
    b, d = cfg.block_size, z1.shape[-1]
    if b is not None and b <= 1 and b < d:
        # R_sum^(1): exactly the off-diagonal penalty (paper §4.4) — the
        # matrix route on the all-reduced correlation accumulator
        c = modes.psum_if(z1.float().T @ z2.float(), cfg.axis_name) / float(total_scale)
        if cfg.q == 2:
            return regs.r_off(c)
        return torch.sum(torch.abs(c)) - torch.sum(torch.abs(torch.diagonal(c)))
    return modes.r_sum_from_psummed(
        z1, z2, cfg.axis_name, q=cfg.q, block_size=b, total_scale=total_scale, impl=_impl(cfg, impl)
    )


def _tp_regularizer(
    z1: Tensor,
    z2: Tensor,
    cfg: DecorrConfig,
    total_scale: float,
    perm: Optional[Tensor],
    impl: Optional[str] = None,
) -> Tensor:
    if cfg.reg == "off" or (cfg.block_size is not None and cfg.block_size <= 1):
        raise NotImplementedError(
            "tp mode supports the R_sum family only (reg='sum', block_size > 1): "
            "the baseline R_off needs the cross-shard d x d matrix."
        )
    same = z1 is z2
    z1f = modes.all_to_all_features(z1.float(), cfg.model_axis)
    z2f = z1f if same else modes.all_to_all_features(z2.float(), cfg.model_axis)
    if cfg.permute and perm is not None:
        z1f, z2f = perm_lib.permute_views(perm, z1f, z2f)
    g = modes.frequency_accumulator(z1f, z2f, cfg.block_size, impl=_impl(cfg, impl))
    g = modes.psum_if(modes.psum_if(g, cfg.model_axis), cfg.axis_name) / float(total_scale)
    return modes.reg_from_accumulator(g, z1f.shape[-1], cfg.block_size, cfg.q)


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
    """Mode / impl-routed decorrelating term R(C).

    ``scale`` is the LOCAL normalizer of C (n_local or n_local - 1).  With
    ``ddof=None`` the ``global`` / ``tp`` modes multiply it by the batch
    axis's size (the reference's historical ``r_sum_global`` semantics);
    with ``ddof`` they normalize by the EXACT effective-batch scale
    max(n_global - ddof, 1), matching one device on the concatenated batch
    (ddof=0: BT-style n; ddof=1: VICReg-style n - 1).  In ``local`` mode
    ``scale`` already is the normalizer and ``ddof`` changes nothing, as in
    the reference.  The permutation is applied inside — callers must NOT
    pre-permute.  ``impl`` overrides the route (see ``core/regularizers.py``).
    """
    mode = effective_mode(cfg)
    if mode == "local":
        return _local_regularizer(z1, z2, cfg, float(scale), perm, impl)
    if ddof is None:
        total = float(scale) * (modes.effective_batch(1, cfg.axis_name) if cfg.axis_name else 1.0)
    else:
        total = max(modes.effective_batch(z1.shape[0], _batch_axis(cfg, mode)) - float(ddof), 1.0)
    route = _global_regularizer if mode == "global" else _tp_regularizer
    return route(z1, z2, cfg, total, perm, impl)


# ---------------------------------------------------------------------------
# Full losses (paper Eq. 14 / Eq. 15), mode-correct end to end
# ---------------------------------------------------------------------------


def barlow_twins(
    z1: Tensor,
    z2: Tensor,
    cfg: DecorrConfig,
    perm: Optional[Tensor] = None,
    *,
    impl: Optional[str] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Eq. (14): sum_i (1 - C_ii)^2 + lam * R(C) on standardized views.  In
    ``global`` / ``tp`` mode every term (standardization moments, diagonal,
    regularizer, n) matches one device on the concatenated, unsharded batch."""
    cfg.validate()
    mode = effective_mode(cfg)
    batch_axis = _batch_axis(cfg, mode)
    n_local = z1.shape[0]
    z1n = standardize(z1, cfg, mode)
    z2n = standardize(z2, cfg, mode)
    # diagonal (invariance) term: C_ii in O(n d) — additive over batch
    # shards (all-reduced over the batch axis) and feature shards (model)
    n_eff = modes.effective_batch(n_local, batch_axis)
    cii = modes.psum_if(torch.sum(z1n * z2n, dim=0), batch_axis) / n_eff
    invariance = torch.sum((1.0 - cii) ** 2)
    if mode == "tp":
        invariance = modes.psum_if(invariance, cfg.model_axis)
    if mode == "local":
        reg = _local_regularizer(z1n, z2n, cfg, float(n_local), perm, impl)
    else:
        route = _global_regularizer if mode == "global" else _tp_regularizer
        reg = route(z1n, z2n, cfg, n_eff, perm, impl)
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
    regularizer of each view at scale n - 1; in ``global`` / ``tp`` mode on
    all-reduced moments, d the full feature width."""
    cfg.validate()
    mode = effective_mode(cfg)
    batch_axis = _batch_axis(cfg, mode)
    n_local, d_local = z1.shape
    z1, z2 = z1.float(), z2.float()
    # invariance: before centering (paper Eq. 3 uses raw embeddings)
    inv = torch.sum((z1 - z2) ** 2)
    if mode == "tp":
        inv = modes.psum_if(inv, cfg.model_axis)
    n_eff = modes.effective_batch(n_local, batch_axis)
    inv = modes.psum_if(inv, batch_axis) / n_eff
    var1 = variance_hinge(z1, cfg, mode)
    var2 = variance_hinge(z2, cfg, mode)
    c1 = center(z1, cfg, mode)
    c2 = center(z2, cfg, mode)
    # each view against itself: ``c is c`` keeps one tensor, so the kernel
    # routes transform it once and autograd sums both operands' gradients
    if mode == "local":
        scale = float(max(n_local - 1, 1))
        reg1 = _local_regularizer(c1, c1, cfg, scale, perm, impl)
        reg2 = _local_regularizer(c2, c2, cfg, scale, perm, impl)
    else:
        scale = max(n_eff - 1.0, 1.0)
        route = _global_regularizer if mode == "global" else _tp_regularizer
        reg1 = route(c1, c1, cfg, scale, perm, impl)
        reg2 = route(c2, c2, cfg, scale, perm, impl)
    d_full = float(d_local)
    if mode == "tp":
        d_full *= modes.effective_batch(1, cfg.model_axis)
    loss = cfg.alpha * inv + (cfg.mu / d_full) * (var1 + var2) + (cfg.nu / d_full) * (reg1 + reg2)
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

    ``perm``: this step's feature permutation (indices, the same on every
    rank), applied inside to the R_sum family only.  ``impl`` overrides the
    regularizer route ("plain" on a CUDA tensor is how the smoke checks the
    kernel route).
    """
    if cfg.style == "bt":
        return barlow_twins(z1, z2, cfg, perm, impl=impl)
    return vicreg(z1, z2, cfg, perm, impl=impl)
