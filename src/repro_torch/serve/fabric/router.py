"""Load-aware replica selection: least-occupancy, weighted-TTFT, affinity
(port of ``repro/serve/fabric/router.py``, line for line).

The router is pure policy — no queues, no threads.  Each ``pick`` reads one
``Replica.snapshot()`` per candidate (the ``slots_occupancy`` /
``queue_depth`` / ``serve_ttft_seconds_p99`` gauges the services already
export) and returns the replica to dispatch to, with a reason string the
fabric narrates into its flight recorder.

Policies:

  * ``least_occupancy`` — minimize ``slots_occupancy + queue_depth /
    slots_total``: instantaneous pool load plus normalized queued backlog,
    deterministic index tie-break.
  * ``weighted_ttft``   — the same load score weighted by each replica's
    observed ``serve_ttft_seconds_p99`` (+1 ms floor, so cold replicas and
    ``Obs.disabled()`` replicas — whose TTFT histogram never observes —
    degrade to pure least-occupancy): a replica that admits fast keeps
    earning traffic, a slow one sheds it.

Consistent-prefix affinity rides on top of either policy for LM traffic:
the CRC of the prompt's leading ``affinity_tokens`` ids maps shared-prefix
fan-out onto ONE replica, the one whose radix cache holds the warm prefix
pages (the reference's ``docs/fabric.md``).  A mapping is dropped the moment its replica is
unhealthy — the next request re-routes by load and re-warms the cache there.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

POLICIES = ("least_occupancy", "weighted_ttft")

# floor added to the observed TTFT p99 before weighting: keeps the score
# finite/ordered for cold (0.0) readings and bounds how hard one slow
# observation can starve a replica
_TTFT_FLOOR_S = 1e-3


def prefix_key(tokens, k: int) -> int:
    """Stable affinity key: CRC32 of the first ``k`` prompt token ids (the
    whole prompt when shorter) — deterministic across processes, unlike
    ``hash``."""
    head = np.asarray(tokens, np.int32)[: max(int(k), 1)]
    return zlib.crc32(head.tobytes())


class Router:
    """Stateless load scoring + the sticky prefix-affinity map."""

    def __init__(self, policy: str = "least_occupancy", affinity_tokens: int = 16):
        if policy not in POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}; pick one of {POLICIES}")
        self.policy = policy
        self.affinity_tokens = int(affinity_tokens)
        self._affinity: Dict[int, str] = {}

    # -- scoring ------------------------------------------------------------

    def score(self, snap: Dict[str, float]) -> float:
        """Lower is better; see the module docstring for the formulas."""
        load = snap["slots_occupancy"] + snap["queue_depth"] / max(snap["slots_total"], 1.0)
        if self.policy == "least_occupancy":
            return load
        return load * (snap["serve_ttft_seconds_p99"] + _TTFT_FLOOR_S)

    def _pick_load(self, healthy: List) -> "object":
        scored = [(self.score(r.snapshot()), i) for i, r in enumerate(healthy)]
        return healthy[min(scored)[1]]

    # -- dispatch -----------------------------------------------------------

    def pick(self, replicas: List, tokens=None) -> Tuple["object", str]:
        """Choose a healthy replica for one request; returns ``(replica,
        reason)`` with reason ``"affinity"`` (sticky prefix hit) or the
        policy name.  Raises ``RuntimeError`` when every replica is dead."""
        healthy = [r for r in replicas if r.alive]
        if not healthy:
            raise RuntimeError("serving fabric has no healthy replica")
        key: Optional[int] = None
        if tokens is not None and self.affinity_tokens > 0:
            key = prefix_key(tokens, self.affinity_tokens)
            name = self._affinity.get(key)
            if name is not None:
                for r in healthy:
                    if r.name == name:
                        return r, "affinity"
                del self._affinity[key]  # mapped replica died; remap below
        chosen = self._pick_load(healthy)
        if key is not None:
            self._affinity[key] = chosen.name
        return chosen, self.policy

    def forget(self, name: str):
        """Drop every affinity mapping onto ``name`` (replica death): the
        warm pages died with it, so stickiness would only pile cold traffic
        onto the requeue target."""
        self._affinity = {k: v for k, v in self._affinity.items() if v != name}

    def metrics(self) -> Dict[str, float]:
        """Router bookkeeping gauges."""
        return {"fabric_affinity_entries": float(len(self._affinity))}
