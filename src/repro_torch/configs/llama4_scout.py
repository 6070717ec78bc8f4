"""Llama-4 Scout 17B-active/16E [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified].  48L d=5120 40H (GQA kv=8) d_ff=8192 vocab=202048 — 16-expert
top-1 MoE with an always-on shared expert; early-fusion frontend stubbed (token ids only).

Port of ``repro/configs/llama4_scout.py``: the same fields, torch dtypes."""

import torch

from repro_torch.models.common import ArchConfig, BlockSpec


def config() -> ArchConfig:
    """The published configuration (bf16 weights and compute)."""
    return ArchConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        pattern=(BlockSpec(mixer="attn", ffn="moe"),),
        n_experts=16,
        top_k=1,
        moe_d_ff=8192,
        shared_expert=True,
        moe_group_size=4096,
        rope_theta=5e5,
        tie_embeddings=False,
        optimizer_moment_dtype=torch.bfloat16,
        source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    )
