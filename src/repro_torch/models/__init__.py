"""repro_torch.models — the decoder LMs of the serving path: attention (GQA,
RoPE and M-RoPE, local / global windows, logit softcaps), MoE FFNs, Mamba
and RWKV6 mixers, and the vision-stub and audio-code frontends — every arch
of ``repro_torch.configs``, for serving and (through ``ParamTree``)
training."""

from repro_torch.models.common import ArchConfig, BlockSpec
from repro_torch.models.transformer import (
    ModelOutput,
    ParamTree,
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
    "ParamTree",
    "forward",
    "init_caches",
    "init_paged_caches",
    "init_params",
    "params_from_jax",
]
