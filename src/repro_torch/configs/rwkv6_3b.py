"""RWKV-6 (Finch) 3B [arXiv:2404.05892; hf].  32L d=2560 attn-free
d_ff=8960 vocab=65536 — data-dependent decay linear recurrence; each layer
is a time-mix (mixer) + channel-mix (ffn) pair.

Port of ``repro/configs/rwkv6_3b.py``: the same fields, torch dtypes."""

from repro_torch.models.common import ArchConfig, BlockSpec


def config() -> ArchConfig:
    """The published configuration (bf16 weights and compute)."""
    return ArchConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=1,  # attention-free; rwkv heads come from rwkv_head_dim
        n_kv_heads=1,
        d_ff=8960,
        vocab_size=65536,
        pattern=(BlockSpec(mixer="rwkv", ffn="rwkv_cmix"),),
        rwkv_head_dim=64,
        rwkv_chunk=64,  # chunk-parallel prefill recurrence
        tie_embeddings=False,
        source="arXiv:2404.05892; hf",
    )
