"""repro_torch.decorr — the decorrelation engine: normalization, permutation, the
``local | global | tp`` modes (``decorr/modes.py``), impl routing and scale
bookkeeping for the losses and regularizers; the serving probe."""

from repro_torch.decorr.config import DecorrConfig
from repro_torch.decorr.engine import (
    apply,
    barlow_twins,
    center,
    effective_mode,
    regularizer,
    standardize,
    variance_hinge,
    vicreg,
)
from repro_torch.decorr.probe import probe_metrics

__all__ = [
    "DecorrConfig",
    "apply",
    "barlow_twins",
    "center",
    "effective_mode",
    "probe_metrics",
    "regularizer",
    "standardize",
    "variance_hinge",
    "vicreg",
]
