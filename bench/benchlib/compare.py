"""The comparison that decides ``correct`` for a training cell.

The system's readings come from the timed path's own first steps (driven
in set-up through the call the window times); the reference's from its
plain run of the same steps on the same weights and batches.  Three
numbers, each with a limit of its own (``<bench>/limits/<cell>.json``):

* ``loss_rel``: the largest |L - L_ref| / |L_ref| over the followed steps;
* ``grad_gap``: over the leaves, the largest gap between the norms of the
  first gradient as the optimizer took it (read from its state after one
  step), |n - n_ref| / max(n_ref, the median leaf's n_ref);
* ``change_gap``: the same gap for the norm of each leaf's change over the
  followed steps, leaving out the leaves whose raw step-0 gradient in the
  reference is under a thousandth of the median leaf's (they move by
  round-off alone).

A number that is not finite fails.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Mapping

GRAD_FLOOR = 1e-3


def leaf_gap(got: Mapping[str, float], want: Mapping[str, float], names: List[str]) -> float:
    """max over ``names`` of |got - want| / max(want, median want)."""
    if not names:
        return 0.0
    med = statistics.median(want[n] for n in names)
    worst = 0.0
    for n in names:
        denom = max(want[n], med)
        gap = abs(got[n] - want[n]) / denom if denom > 0 else (0.0 if got[n] == 0 else math.inf)
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def moved_leaves(reference: Mapping) -> List[str]:
    """The leaves whose raw step-0 gradient is at least a thousandth of the median leaf's."""
    grads = reference["grads"]
    med = statistics.median(grads.values())
    return [n for n, g in grads.items() if g >= GRAD_FLOOR * med]


def numbers(program: Mapping, reference: Mapping) -> Dict[str, float]:
    """The three compared numbers (see the module note)."""
    pl, rl = program["losses"], reference["losses"]
    if len(pl) != len(rl):
        raise ValueError(f"{len(pl)} program losses for {len(rl)} reference losses")
    loss_rel = max((abs(a - b) / abs(b) if b != 0 else math.inf) for a, b in zip(pl, rl))
    if any(not math.isfinite(x) for x in pl):
        loss_rel = math.inf
    names = sorted(reference["first_grads"])
    missing = set(names) ^ set(program["first_grads"])
    if missing:
        raise ValueError(f"leaves differ between the program and the reference: {sorted(missing)}")
    return {
        "loss_rel": loss_rel,
        "grad_gap": leaf_gap(program["first_grads"], reference["first_grads"], names),
        "change_gap": leaf_gap(program["changes"], reference["changes"], moved_leaves(reference)),
    }


def judge(values: Mapping[str, float], limits: Mapping[str, float]) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} for every limited number; ``passed`` below."""
    out = {}
    for name, limit in limits.items():
        if name not in values:
            raise KeyError(f"no number {name!r} to hold against its limit")
        out[name] = {"value": values[name], "limit": float(limit)}
    return out


def passed(checks: Mapping[str, Mapping[str, float]]) -> bool:
    """Every number finite and within its limit."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
