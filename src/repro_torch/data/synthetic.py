"""Deterministic synthetic data, port of ``repro/data/synthetic.py`` (numpy
only, bit-identical to the reference).

Batches are keyed by (seed, step): restart-safe and reproducible — a resumed
run gets exactly the batches an uninterrupted one would.

* LM stream: Markov-ish token ids with a planted multiplicative structure,
  so the cross-entropy falls during a training run.
* SSL stream: latent-factor vectors rendered to "images"; two views come
  from the paper's augmentation semantics (crop -> coordinate mask, color
  jitter -> channel scale / shift, noise) in vector form.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    """Shape of the LM stream; ``n_codebooks`` > 0 gives audio codes
    (B, S, n_codebooks)."""

    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    n_codebooks: int = 0


def lm_batch(cfg: LMDataConfig, step: int) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic tokens: t_{i+1} = (31 t_i + noise) % V; returns
    int32 ``tokens`` and next-token ``labels``, each (B, S[, n_codebooks])."""
    rng = np.random.default_rng(np.uint64(cfg.seed * 1_000_003 + step))
    shape = (cfg.batch, cfg.seq_len + 1)
    if cfg.n_codebooks:
        shape = shape + (cfg.n_codebooks,)
    first = rng.integers(0, cfg.vocab_size, size=(cfg.batch, 1) + shape[2:])
    noise = rng.integers(0, 17, size=shape)
    toks = np.empty(shape, np.int64)
    toks[:, 0] = first[:, 0]
    mult = 31
    for i in range(1, shape[1]):
        toks[:, i] = (toks[:, i - 1] * mult + noise[:, i]) % cfg.vocab_size
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def lm_iterator(cfg: LMDataConfig, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Endless stream of ``lm_batch(cfg, step)`` from ``start_step`` on."""
    step = start_step
    while True:
        yield lm_batch(cfg, step)
        step += 1


# ---------------------------------------------------------------------------
# SSL two-view stream (the paper's setting)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SSLDataConfig:
    """Shape and augmentation strengths of the two-view stream."""

    input_dim: int = 3072
    latent_dim: int = 64
    batch: int = 256
    seed: int = 0
    noise: float = 0.1
    mask_prob: float = 0.25  # "random crop" analogue
    jitter: float = 0.2  # "color jitter" analogue


def _render(latents: np.ndarray, w: np.ndarray) -> np.ndarray:
    return np.tanh(latents @ w)


def ssl_batch(cfg: SSLDataConfig, step: int) -> Tuple[np.ndarray, np.ndarray]:
    """Returns two augmented views (B, input_dim) of the same latents."""
    rng = np.random.default_rng(np.uint64(cfg.seed * 7_000_003 + step))
    w_rng = np.random.default_rng(np.uint64(cfg.seed + 12345))  # fixed decoder
    w = w_rng.normal(size=(cfg.latent_dim, cfg.input_dim)).astype(np.float32)
    w /= np.sqrt(cfg.latent_dim)
    latents = rng.normal(size=(cfg.batch, cfg.latent_dim)).astype(np.float32)
    base = _render(latents, w)

    views = []
    for _ in range(2):
        v = base.copy()
        # channel jitter (scale + shift)
        scale = 1.0 + cfg.jitter * rng.uniform(-1, 1, size=(cfg.batch, 1)).astype(np.float32)
        shift = cfg.jitter * rng.uniform(-1, 1, size=(cfg.batch, 1)).astype(np.float32)
        v = v * scale + shift
        # random coordinate mask ("crop")
        mask = rng.random(size=v.shape) > cfg.mask_prob
        v = v * mask.astype(np.float32)
        # pixel noise
        v = v + cfg.noise * rng.normal(size=v.shape).astype(np.float32)
        views.append(v)
    return views[0], views[1]


def ssl_iterator(cfg: SSLDataConfig, start_step: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless stream of ``ssl_batch(cfg, step)`` from ``start_step`` on."""
    step = start_step
    while True:
        yield ssl_batch(cfg, step)
        step += 1
