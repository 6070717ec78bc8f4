"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B; hf].  32L d=4096 32H (GQA kv=32 =
MHA) d_ff=13440 vocab=92416 — qwen1.5 arch, QKV bias.

Port of ``repro/configs/codeqwen1_5_7b.py``: the same fields, torch dtypes."""

from repro_torch.models.common import ArchConfig, BlockSpec


def config() -> ArchConfig:
    """The published configuration (bf16 weights and compute)."""
    return ArchConfig(
        name="codeqwen1.5-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=13440,
        vocab_size=92416,
        pattern=(BlockSpec(mixer="attn", ffn="dense"),),
        qkv_bias=True,
        rope_theta=1e6,
        tie_embeddings=False,
        source="hf:Qwen/CodeQwen1.5-7B; hf",
    )
