"""Optimizers of the port (LARS, AdamW, SGD) and gradient utilities."""

from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    clip_by_global_norm,
    global_norm,
    lars,
    sgd_momentum,
    warmup_cosine,
)
