"""Decorrelation as a training feature of the LM architectures (port of
``repro/core/decorrelation.py``).

The paper's regularizer is feature-space, not architecture-space, so it
attaches to any model as an *auxiliary loss* on hidden states: the
VICReg-style covariance regularizer (single view — an LM needs no
augmentation pair) on a strided subsample of the final hidden states,

    L = L_ce + mu/d * R_var(K(H)) + nu/d * R(K(H))

with R = R_sum / R_sum^(b) through the FFT — O(n d log d) on top of a
6 N D training step.  The engine (``decorr/engine.py``) owns the
permutation, the route and the scale; on a CUDA tensor R runs the
hand-written kernels forward and backward, on a CPU tensor their plain
versions.  The step's permutation comes in as indices (``perm=``), as in
``train/ssl.py`` (see ``core/permutation.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.decorr import engine as decorr_engine
from repro_torch.decorr.config import DecorrConfig

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LMDecorrConfig:
    """Auxiliary decorrelation on LM hidden states.

    enabled:        off by default; archs opt in through their config.
    tokens_per_seq: subsample stride target — caps the statistic's batch at
                    batch * tokens_per_seq rows (a bounded n at any length).
    """

    enabled: bool = False
    decorr: DecorrConfig = dataclasses.field(default_factory=lambda: DecorrConfig(style="vic", reg="sum"))
    tokens_per_seq: int = 8
    mu: float = 1.0
    nu: float = 0.04

    def validate(self) -> "LMDecorrConfig":
        """Raise on an invalid engine config or stride; returns self."""
        self.decorr.validate()
        if self.tokens_per_seq < 1:
            raise ValueError(f"tokens_per_seq must be >= 1, got {self.tokens_per_seq}")
        return self


def subsample_tokens(h: Tensor, tokens_per_seq: int) -> Tensor:
    """(B, S, D) -> (B * min(S, tokens_per_seq), D), strided and static."""
    b, s, d = h.shape
    take = min(s, tokens_per_seq)
    stride = max(1, s // take)
    return h[:, ::stride, :][:, :take, :].reshape(b * take, d)


def lm_decorrelation_loss(
    hidden: Tensor,
    cfg: LMDecorrConfig,
    perm: Optional[Tensor] = None,
    *,
    impl: Optional[str] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Covariance decorrelation aux loss on hidden states (single view).

    ``hidden``: (B, S, D) final hidden states (pre-LM-head); ``perm``: this
    step's feature permutation (R_sum family only); ``impl`` overrides the
    regularizer's route (``"plain"`` on a CUDA tensor is how the smoke holds
    the kernel route).  Returns (aux_loss, metrics).  Disabled, the loss is
    a host zero: a step without the aux loss issues no device op for it.
    """
    cfg.validate()
    if not cfg.enabled:
        zero = torch.zeros(())
        return zero, {"decorr_aux": zero}

    z = subsample_tokens(hidden, cfg.tokens_per_seq)
    n, d = z.shape
    zc = decorr_engine.center(z, cfg.decorr)
    var = decorr_engine.variance_hinge(z, cfg.decorr)
    # the engine owns the permutation and the route; ddof=1 keeps the
    # n - 1 normalizer of the variance hinge above
    scale = float(max(n - 1, 1))
    reg = decorr_engine.regularizer(zc, zc, cfg.decorr, scale, perm, ddof=1, impl=impl)
    aux = (cfg.mu / d) * var + (cfg.nu / d) * reg
    return aux, {"decorr_aux": aux, "decorr_var": var, "decorr_reg": reg}
