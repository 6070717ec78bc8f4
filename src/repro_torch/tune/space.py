"""Plan candidate spaces (port of the plan parts of ``repro/tune/space.py``).

Only the *plan* kernels are here: ``sumvec_fft_plan`` (the four-step
factorization d -> (dp, d1, d2)) and the grouped regularizer's block sizes.
Both are semantic choices, identical on every backend, so the port copies
the reference's enumeration exactly and picks the same plan.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

Config = Dict[str, int]


def balanced_factors(x: int) -> Tuple[int, int]:
    """(d1, d2), d1 <= d2, d1 * d2 == x, d1 as large as possible."""
    for d1 in range(int(math.isqrt(x)), 0, -1):
        if x % d1 == 0:
            return d1, x // d1
    return 1, x


def _divisor_factorizations(x: int, limit: int = 8) -> List[Tuple[int, int]]:
    out = []
    for d1 in range(int(math.isqrt(x)), 0, -1):
        if x % d1 == 0:
            out.append((d1, x // d1))
        if len(out) >= limit:
            break
    return out


def padded_plan_candidates(d: int, scan: int = 256, keep: int = 4) -> List[Config]:
    """Tile-friendly padded DFT lengths dp >= 2d - 1 with balanced factors.

    Zero-padding the feature axis to dp and folding the linear correlation
    back to d circular lags is exact (see ``kernels/sumvec_fft/ops.py``), so
    any dp here preserves the loss; a bounded window above 2d - 1 is scanned
    for highly composite lengths and the cheapest few by the four-step FLOP
    proxy dp * (d1 + d2) are kept.
    """
    lo = max(2 * d - 1, 2)
    scored = []
    for dp in range(lo, lo + scan):
        d1, d2 = balanced_factors(dp)
        if d1 < max(2, math.isqrt(dp) // 4):
            continue  # too lopsided to beat the direct DFT reliably
        scored.append((dp * (d1 + d2), {"dp": dp, "d1": d1, "d2": d2}))
    scored.sort(key=lambda t: (t[0], t[1]["dp"]))
    return [cfg for _, cfg in scored[:keep]]


def is_legal_plan(d: int, cfg: Config) -> bool:
    """A four-step plan is legal when dp == d1 * d2 and either exact
    (dp == d) or linear-correlation safe (dp >= 2d - 1, no wraparound)."""
    dp, d1, d2 = cfg["dp"], cfg["d1"], cfg["d2"]
    if d1 * d2 != dp or d1 < 1 or d2 < 1:
        return False
    return dp == d or dp >= 2 * d - 1


def sumvec_fft_plan_candidates(d: int) -> List[Config]:
    """All legal four-step plans for length d, exact factorizations first
    (the balanced default is the first of them)."""
    out: List[Config] = [{"dp": d, "d1": d1, "d2": d2} for d1, d2 in _divisor_factorizations(d)]
    out.extend(padded_plan_candidates(d))
    return [cfg for cfg in out if is_legal_plan(d, cfg)]


def grouped_block_size_candidates(d: int) -> List[int]:
    """Legal grouped-regularizer block sizes b for width d: powers of two
    from 2 up to d, plus d itself (== ungrouped Eq. 6)."""
    out = []
    b = 2
    while b < d:
        out.append(b)
        b *= 2
    out.append(d)
    return out
