"""Inference-time decorrelation probes (port of ``repro/decorr/probe.py``).

``probe_metrics`` measures the representation health of a served batch with
the training loss's semantics: the same normalization (standardize for
BT-style, center for VICReg-style; rank-local moments in ``local`` mode,
all-reduced global moments in ``global`` / ``tp`` mode), the same feature
permutation (the caller's indices, the same on every rank), the same scale
(n for BT, n - 1 for VICReg), routed through ``repro_torch.decorr.engine``.
In ``global`` / ``tp`` mode it runs on every rank of the mesh installed by
``parallel.sharding.sharding_context``, each with its block of the batch
(``tp``: its block of rows and of features), and every output is the
statistic of the whole batch, the same on every rank.

  * ``r_sum`` — the paper's O(n d log d) statistic; always computed (its
    route follows the tensor's device: kernels on CUDA).
  * ``r_off`` — the exact off-diagonal mass, O(n d^2); computed only when
    affordable (``include_off``; auto = d <= 4096 and mode != 'tp').

Serving has one embedding per request, so the default is the self-
correlation probe ``z2 is z1``; pass a second view to probe cross-correlation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from repro_torch.decorr import engine, modes
from repro_torch.decorr.config import DecorrConfig

Tensor = torch.Tensor

def slot_probe_rows(hidden: Tensor, active: Sequence[int]) -> Tensor:
    """The in-flight slots' representation rows of one continuous-batching
    decode step.

    ``hidden``: (n_slots, d) final hidden states of the step, on the step's
    device (free-slot lanes carry garbage); ``active``: the slots that held
    live requests WHEN the step ran.  Returns the (n_active, d) f32 rows in
    slot order, on the same device: the stream ``serve.DecorrProbe``
    buffers into its fixed probe windows, so a reading only ever mixes rows
    of real, in-flight requests.
    """
    return hidden[torch.as_tensor(list(active), dtype=torch.long, device=hidden.device)].float()


# r_off materializes d x d — beyond this width the probe drops it and relies
# on the O(n d log d) r_sum statistic alone.
OFF_DIAG_AUTO_LIMIT = 4096


def _should_include_off(cfg: DecorrConfig, d: int, include_off: Optional[bool]) -> bool:
    if include_off is not None:
        return include_off
    return d <= OFF_DIAG_AUTO_LIMIT and engine.effective_mode(cfg) != "tp"


def probe_metrics(
    z1: Tensor,
    z2: Optional[Tensor] = None,
    cfg: DecorrConfig = DecorrConfig(),
    perm: Optional[Tensor] = None,
    *,
    include_off: Optional[bool] = None,
    impl: Optional[str] = None,
) -> Dict[str, Tensor]:
    """Decorrelation health of a served batch, training-oracle-exact.

    Returns a flat dict of f32 scalar tensors (replicated over the mesh):

      r_sum        engine-routed R_sum at the training normalizer
      r_sum_norm   r_sum / (d - 1)  (comparable across widths)
      r_off        exact off-diagonal penalty (present when affordable)
      r_off_norm   Eq. (16)-style r_off / (d (d - 1))
      mean_abs     mean_j |mu_j| of the raw embeddings (effective batch)
      std_err      mean_j |sigma_j - 1| (unit-variance drift)
      diag_err     mean_j |1 - C_jj| cross-view alignment (z2 given only)
      n_eff        effective batch the statistics were taken over

    ``impl`` overrides the regularizer route ("plain" on a CUDA tensor is
    how the smoke checks the kernel route on the card).
    """
    cfg.validate()
    mode = engine.effective_mode(cfg)
    same = z2 is None or z2 is z1
    z1 = z1.float()
    z2 = z1 if same else z2.float()
    n_local, d_local = z1.shape
    batch_axis = cfg.axis_name if mode in ("global", "tp") else None
    n_eff = modes.effective_batch(n_local, batch_axis)
    p_model = modes.effective_batch(1, cfg.model_axis) if mode == "tp" else 1.0
    d = int(d_local * p_model)

    def model_mean(x: Tensor) -> Tensor:
        # tp: a mean over this rank's features -> the mean over all of them
        return modes.psum_if(x, cfg.model_axis) / p_model if mode == "tp" else x

    # raw-moment drift (mode-effective batch statistics, O(n d))
    mean = modes.psum_if(torch.sum(z1, dim=0), batch_axis) / n_eff
    zc = z1 - mean
    var = modes.psum_if(torch.sum(zc * zc, dim=0), batch_axis) / max(n_eff - 1.0, 1.0)
    out: Dict[str, Tensor] = {}

    # training-identical normalization + scale
    if cfg.style == "bt":
        a = engine.standardize(z1, cfg, mode)
        b = a if same else engine.standardize(z2, cfg, mode)
        ddof = 0
    else:
        a = engine.center(z1, cfg, mode)
        b = a if same else engine.center(z2, cfg, mode)
        ddof = 1
    # local mode takes the explicit scale; global / tp recompute the exact
    # effective-batch normalizer from ddof (engine semantics)
    scale = max(n_local - ddof, 1)

    sum_cfg = cfg if cfg.reg == "sum" else dataclasses.replace(cfg, reg="sum")
    out["r_sum"] = engine.regularizer(a, b, sum_cfg, scale, perm, ddof=ddof, impl=impl)
    out["r_sum_norm"] = out["r_sum"] / max(d - 1, 1)
    if _should_include_off(cfg, d, include_off):
        off_cfg = dataclasses.replace(cfg, reg="off", use_kernel=False)
        out["r_off"] = engine.regularizer(a, b, off_cfg, scale, perm, ddof=ddof)
        out["r_off_norm"] = out["r_off"] / max(d * (d - 1), 1)

    out["mean_abs"] = model_mean(torch.mean(torch.abs(mean)))
    out["std_err"] = model_mean(torch.mean(torch.abs(torch.sqrt(var + cfg.eps) - 1.0)))
    if not same:
        if cfg.style == "bt":
            cjj = modes.psum_if(torch.sum(a * b, dim=0), batch_axis) / n_eff
            out["diag_err"] = model_mean(torch.mean(torch.abs(1.0 - cjj)))
        else:
            inv = modes.psum_if(torch.sum((z1 - z2) ** 2), batch_axis)
            if mode == "tp":
                inv = modes.psum_if(inv, cfg.model_axis)
            out["diag_err"] = inv / (n_eff * d)
    out["n_eff"] = torch.tensor(float(n_eff), dtype=torch.float32, device=z1.device)
    return out
