"""Nemotron-4-340B [arXiv:2402.16819; unverified].  96L d=18432 96H (GQA
kv=8) d_ff=73728 vocab=256000 — squared-ReLU MLP (no gate).

Port of ``repro/configs/nemotron4_340b.py``: the same fields, torch dtypes."""

import torch

from repro_torch.models.common import ArchConfig, BlockSpec


def config() -> ArchConfig:
    """The published configuration (bf16 weights and compute)."""
    return ArchConfig(
        name="nemotron-4-340b",
        family="dense",
        n_layers=96,
        d_model=18432,
        n_heads=96,
        n_kv_heads=8,
        d_ff=73728,
        vocab_size=256000,
        pattern=(BlockSpec(mixer="attn", ffn="dense"),),
        activation="squared_relu",
        rope_theta=10000.0,
        tie_embeddings=False,
        optimizer_moment_dtype=torch.bfloat16,
        source="arXiv:2402.16819; unverified",
    )
