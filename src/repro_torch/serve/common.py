"""Shared token-model serving helpers (port of ``repro/serve/common.py``):
seeded prompt construction and the warmup-then-time generate loop."""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device

Tensor = torch.Tensor


def make_prompt(cfg, seed: int, batch: int, prompt_len: int, device: DeviceLike = None) -> Tensor:
    """Random int32 token prompt from a numpy seed with the frontend's shape:
    (batch, prompt_len) for token models (the vision stub's included),
    (batch, prompt_len, n_codebooks) for audio-code models; on ``device``
    (``cuda`` unless ``"cpu"`` is passed; the reference draws from a JAX
    key, so the two streams differ)."""
    shape = (batch, prompt_len, cfg.n_codebooks) if cfg.frontend == "audio_codes" else (batch, prompt_len)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
    return torch.as_tensor(toks, device=resolve_device(device))


def _sync(x: Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def timed_generate(
    params, cfg, prompt: Tensor, new_tokens: int, *, warmup_tokens: int = 2, steps=None
) -> Tuple[Tensor, Dict[str, float]]:
    """Warm up, then time one greedy generate call.  Returns (tokens, stats)
    with ``seconds``, ``tokens`` (new tokens across the batch) and
    ``tok_per_s``."""
    from repro_torch.train.serve import greedy_generate

    max_len = prompt.shape[1] + new_tokens
    if warmup_tokens > 0:
        _sync(greedy_generate(params, cfg, prompt, min(warmup_tokens, new_tokens), max_len=max_len, steps=steps))
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, prompt, new_tokens, max_len=max_len, steps=steps)
    _sync(out)
    dt = time.perf_counter() - t0
    n_tok = int(prompt.shape[0]) * new_tokens
    return out, {"seconds": dt, "tokens": float(n_tok), "tok_per_s": n_tok / max(dt, 1e-9)}
