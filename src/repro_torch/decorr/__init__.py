"""repro_torch.decorr — the decorrelation engine (``local`` mode) and probes."""

from repro_torch.decorr.config import DecorrConfig
from repro_torch.decorr.engine import center, effective_mode, regularizer, standardize
from repro_torch.decorr.probe import probe_metrics

__all__ = [
    "DecorrConfig",
    "center",
    "effective_mode",
    "probe_metrics",
    "regularizer",
    "standardize",
]
