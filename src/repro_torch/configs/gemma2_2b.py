"""Gemma2-2B [arXiv:2408.00118; hf] (port of ``repro/configs/gemma2_2b.py``).
26L d=2304 8H (GQA kv=4) d_ff=9216 vocab=256000 — local(4096)+global
alternating, attn softcap 50, final logit softcap 30, sandwich (pre+post)
norms, embedding scaled by sqrt(d)."""

from repro_torch.models.common import ArchConfig, BlockSpec


def config() -> ArchConfig:
    """The published gemma2-2b configuration (bf16 weights and compute)."""
    return ArchConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        pattern=(
            BlockSpec(mixer="attn", attn_type="local", ffn="dense"),
            BlockSpec(mixer="attn", attn_type="global", ffn="dense"),
        ),
        window_size=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        post_block_norm=True,
        scale_embed=True,
        activation="gelu",
        attn_scale=1.0 / 16.0,  # query_pre_attn_scalar = 256
        tie_embeddings=True,
        source="arXiv:2408.00118; hf",
    )
