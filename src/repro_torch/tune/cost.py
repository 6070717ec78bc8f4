"""Analytic plan cost (port of the ``sumvec_fft_plan`` part of
``repro/tune/cost.py``).

The four-step plan is ranked flops-first, exactly as the reference ranks it
(``rank_key`` for plan kernels), so the port and the reference pick the same
factorization for every d.  These are counts of the algorithm's work, not
times of any device.
"""

from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.tune.space import Config, sumvec_fft_plan_candidates

F32 = 4
# batch the plan cost amortizes batch-independent stages over (the paper's
# SSL batch); plans are chosen per d, so one representative n is used
NOMINAL_BATCH = 256


def sumvec_fft_plan_cost(d: int, cfg: Config) -> Dict[str, float]:
    """Closed-form {flops, hbm_bytes} of a four-step plan at NOMINAL_BATCH rows."""
    dp, d1, d2 = cfg["dp"], cfg["d1"], cfg["d2"]
    padded = dp > d
    # forward per batch row (both views: two cmatmul stages + one twiddle);
    # the inverse runs once on the batch-reduced accumulator
    fwd = 16.0 * dp * (d1 + d2) + 12.0 * dp
    inv = 8.0 * dp * (d1 + d2) + 6.0 * dp
    flops = NOMINAL_BATCH * fwd + (inv if padded else 0.0)
    hbm = F32 * (6.0 * dp * NOMINAL_BATCH + 2.0 * (d1 * d1 + d2 * d2))
    return {"flops": float(flops), "hbm_bytes": float(hbm)}


def rank_key(cost: Dict[str, float]) -> Tuple[float, float]:
    """Plans rank flops-first (padding traded against factor balance is
    arithmetic), then bytes — the reference's order for plan kernels."""
    return (cost["flops"], cost["hbm_bytes"])


def best_sumvec_fft_plan(d: int) -> Config:
    """The analytic pick over ``sumvec_fft_plan_candidates`` (first minimum)."""
    cands = sumvec_fft_plan_candidates(d)
    return min(cands, key=lambda c: rank_key(sumvec_fft_plan_cost(d, c)))
