"""Qwen1.5-110B [hf:Qwen/Qwen1.5-0.5B family; hf].  80L d=8192 64H (GQA kv=8)
d_ff=49152 vocab=152064 — QKV bias.

Port of ``repro/configs/qwen1_5_110b.py``: the same fields, torch dtypes."""

from repro_torch.models.common import ArchConfig, BlockSpec


def config() -> ArchConfig:
    """The published configuration (bf16 weights and compute)."""
    return ArchConfig(
        name="qwen1.5-110b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=49152,
        vocab_size=152064,
        pattern=(BlockSpec(mixer="attn", ffn="dense"),),
        qkv_bias=True,
        rope_theta=1e6,
        tie_embeddings=False,
        source="hf:Qwen/Qwen1.5-0.5B; hf",
    )
