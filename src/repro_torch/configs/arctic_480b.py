"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base; hf].  35L
d=7168 56H (GQA kv=8) vocab=32000 — 128-expert top-2 MoE (expert d_ff=4864)
with a DENSE residual MLP in parallel on every layer.

Port of ``repro/configs/arctic_480b.py``: the same fields, torch dtypes."""

import torch

from repro_torch.models.common import ArchConfig, BlockSpec


def config() -> ArchConfig:
    """The published configuration (bf16 weights and compute)."""
    return ArchConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        pattern=(BlockSpec(mixer="attn", ffn="moe"),),
        n_experts=128,
        top_k=2,
        moe_d_ff=4864,
        dense_residual=True,
        moe_group_size=4096,  # dispatch per 4096-token group: O(T*G), not O(T^2)
        tie_embeddings=False,
        optimizer_moment_dtype=torch.bfloat16,
        source="hf:Snowflake/snowflake-arctic-base; hf",
    )
