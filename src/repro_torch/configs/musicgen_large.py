"""MusicGen-large [arXiv:2306.05284; hf].  48L d=2048 32H (MHA) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens.  The EnCodec frontend is a
STUB: inputs are (B, S, n_q=4) codebook token ids; the
backbone sums per-codebook embeddings and predicts 4 parallel heads.

Port of ``repro/configs/musicgen_large.py``: the same fields, torch dtypes."""

from repro_torch.models.common import ArchConfig, BlockSpec


def config() -> ArchConfig:
    """The published configuration (bf16 weights and compute)."""
    return ArchConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        pattern=(BlockSpec(mixer="attn", ffn="dense"),),
        activation="gelu",
        frontend="audio_codes",
        n_codebooks=4,
        tie_embeddings=False,
        source="arXiv:2306.05284; hf",
    )
