"""Jamba v0.1 52B [arXiv:2403.19887; hf].  32L d=4096 32H (GQA kv=8)
d_ff=14336 vocab=65536 — Mamba:attention 7:1 interleave (attention at
position 4 of each 8-layer period), 16-expert top-2 MoE on every other
layer (odd positions).

Port of ``repro/configs/jamba_v01_52b.py``: the same fields, torch dtypes."""

import torch

from repro_torch.models.common import ArchConfig, BlockSpec


def config() -> ArchConfig:
    """The published configuration (bf16 weights and compute)."""
    # 8-layer period: attn at index 4 (1:7), MoE at odd indices (every other)
    pattern = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        pattern.append(BlockSpec(mixer=mixer, ffn=ffn))
    return ArchConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        pattern=tuple(pattern),
        n_experts=16,
        top_k=2,
        moe_d_ff=14336,
        ssm_d_state=16,
        ssm_d_conv=4,
        ssm_expand=2,
        moe_group_size=4096,
        tie_embeddings=False,
        ssm_unroll=8,
        optimizer_moment_dtype=torch.bfloat16,
        source="arXiv:2403.19887; hf",
    )
