"""Deterministic synthetic SSL data, port of the SSL stream of
``repro/data/synthetic.py`` (numpy only, bit-identical to the reference).

Batches are keyed by (seed, step): restart-safe and reproducible — a resumed
run gets exactly the batches an uninterrupted one would.  Latent-factor
vectors are rendered to "images"; two views come from the paper's
augmentation semantics (crop -> coordinate mask, color jitter -> channel
scale / shift, noise) in vector form.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


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
