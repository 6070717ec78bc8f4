"""repro_torch.models — the decoder LM of the serving path (dense attention
patterns: GQA, RoPE, local / global windows, logit softcaps)."""

from repro_torch.models.common import ArchConfig, BlockSpec
from repro_torch.models.transformer import (
    ModelOutput,
    forward,
    init_caches,
    init_paged_caches,
    init_params,
    params_from_jax,
)

__all__ = [
    "ArchConfig",
    "BlockSpec",
    "ModelOutput",
    "forward",
    "init_caches",
    "init_paged_caches",
    "init_params",
    "params_from_jax",
]
