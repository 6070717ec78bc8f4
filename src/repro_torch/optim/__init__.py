"""Optimizers of the port (LARS, AdamW, SGD), gradient utilities and the
compressed data-parallel all-reduce (``optim.compression``)."""

from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    clip_by_global_norm,
    clip_by_global_norm_,
    global_norm,
    lars,
    sgd_momentum,
    warmup_cosine,
)
from repro_torch.optim.compression import bf16_psum, init_error_feedback, int8_psum_ef
