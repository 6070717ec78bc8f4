"""Model FLOPs of an RWKV-6 training step: 6 x (the parameters of every
matrix product, the embedding lookup left out) x (tokens stepped).  The
WKV recurrence's own products, the norms, the loss and the optimizer are
not counted, nor is the recomputation that rematerialisation adds."""

from __future__ import annotations

from typing import Dict

LORA_DIM = 32


def matmul_params(config: Dict) -> int:
    """Entries of the matrices a token is multiplied by: per layer the time
    mix's five d x d products, its two low-rank adapters and the channel
    mix's three; the head."""
    d, f, v = config["d_model"], config["d_ff"], config["vocab_size"]
    layer = 5 * d * d + 2 * (d * 5 * LORA_DIM) + 2 * (d * LORA_DIM) + 2 * d * f + d * d
    return config["n_layers"] * layer + d * v


def step_flops(config: Dict, batch: int, seq: int) -> float:
    """Forward and backward FLOPs of one step of ``batch`` sequences of ``seq`` tokens."""
    return 6.0 * matmul_params(config) * batch * seq
