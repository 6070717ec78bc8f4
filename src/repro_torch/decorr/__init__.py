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
from repro_torch.decorr.warmup import mesh_parallelism, shard_local_shape, warmup_tune_cache

__all__ = [
    "DecorrConfig",
    "apply",
    "barlow_twins",
    "center",
    "effective_mode",
    "mesh_parallelism",
    "probe_metrics",
    "regularizer",
    "shard_local_shape",
    "standardize",
    "variance_hinge",
    "vicreg",
    "warmup_tune_cache",
]
