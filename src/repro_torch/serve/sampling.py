"""Temperature / top-k sampling for the continuous-batching decode loop
(port of ``repro/serve/sampling.py``; numpy only, copied — the port imports
nothing of the reference).

Sampling happens on the host, on the logits row the decode step returns:
the pool's batched step stays sampling-agnostic (a sampling engine returns
logits; a greedy engine keeps its argmax on the device), while each request
carries its own ``SamplingParams`` and its own random stream.

Determinism contract:

  * ``temperature == 0`` is EXACT greedy: ``np.argmax`` over the host's
    logits row, which equals the device argmax (same f32 values, both break
    ties toward the lowest index).
  * ``temperature > 0`` uses the Gumbel-max trick on the temperature-scaled,
    top-k-masked logits with a per-request ``np.random.Generator`` seeded
    from ``SamplingParams.seed``.  The stream is numpy's, so the same seed
    and the same logits give the same tokens here and in the reference, and
    a request replayed with the same seed reproduces its tokens however slot
    interleaving schedules it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding policy.

    temperature: 0 = greedy (the default; identical to the argmax path);
                 > 0 softens the distribution before sampling.
    top_k:       keep only the k highest logits (None/0 = full vocab).
    seed:        per-request seed; None derives one from the pool's
                 admission counter so replays are still deterministic.
    """

    temperature: float = 0.0
    top_k: Optional[int] = None
    seed: Optional[int] = None

    def validate(self) -> "SamplingParams":
        """Range-check the knobs; returns self for chaining."""
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k is not None and self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0/None = full vocab), got {self.top_k}")
        return self

    @property
    def greedy(self) -> bool:
        """True when temperature 0 makes sampling exact argmax."""
        return self.temperature == 0.0


GREEDY = SamplingParams()


def make_rng(params: Optional[SamplingParams], fallback_seed: int) -> Optional[np.random.Generator]:
    """The request's private random stream (None for greedy requests —
    greedy consumes no entropy, so its path has no generator to drift)."""
    if params is None or params.greedy:
        return None
    seed = params.seed if params.seed is not None else fallback_seed
    return np.random.default_rng(int(seed))


def sample_token(
    logits: np.ndarray,
    params: Optional[SamplingParams],
    rng: Optional[np.random.Generator],
) -> int:
    """Draw the next token id from one (V,) f32 logits row."""
    if params is None or params.greedy:
        return int(np.argmax(logits))
    z = np.asarray(logits, np.float64) / params.temperature
    if params.top_k:
        k = min(int(params.top_k), z.shape[0])
        # mask everything below the k-th largest logit (argpartition is
        # enough: only membership matters, the Gumbel noise breaks ties)
        keep = np.argpartition(z, -k)[-k:]
        masked = np.full_like(z, -np.inf)
        masked[keep] = z[keep]
        z = masked
    gumbel = -np.log(-np.log(rng.uniform(low=np.finfo(np.float64).tiny, high=1.0, size=z.shape)))
    return int(np.argmax(z + gumbel))
