"""Qwen2-VL-2B backbone [arXiv:2409.12191; hf].  28L d=1536 12H (GQA kv=2)
d_ff=8960 vocab=151936 — M-RoPE, dynamic resolution.  Vision frontend is a
STUB: callers pass precomputed patch embeddings (``forward(embeds=...)``)
plus the (3, B, S) M-RoPE position streams.

Port of ``repro/configs/qwen2_vl_2b.py``: the same fields, torch dtypes."""

from repro_torch.models.common import ArchConfig, BlockSpec


def config() -> ArchConfig:
    """The published configuration (bf16 weights and compute)."""
    return ArchConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        pattern=(BlockSpec(mixer="attn", ffn="dense"),),
        mrope=True,
        mrope_sections=(16, 24, 24),
        qkv_bias=True,
        rope_theta=1e6,
        frontend="vision_stub",
        tie_embeddings=True,
        source="arXiv:2409.12191; hf",
    )
