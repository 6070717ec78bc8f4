"""Liveness tracking (port of ``HeartbeatMonitor`` from ``repro/ft/watchdog.py``)."""

from __future__ import annotations

import re
import time
from typing import Callable, Dict, Optional

_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    """Map an arbitrary gauge key onto the Prometheus metric-name grammar."""
    out = _INVALID.sub("_", str(name))
    if not out or out[0].isdigit():
        out = "_" + out
    return out


class HeartbeatMonitor:
    """Liveness tracking for long-running components (the serve dispatch
    loop).  Components ``register`` with a timeout and ``beat`` on every
    unit of progress; ``stale()`` reports those whose last beat is older
    than their timeout.  Fresh->stale transitions are counted once each
    (``missed_events``).  ``clock`` is injectable so tests never sleep.
    """

    def __init__(self, default_timeout_s: float = 10.0, clock: Callable[[], float] = time.monotonic):
        self.default_timeout_s = default_timeout_s
        self._clock = clock
        self._last: Dict[str, float] = {}
        self._timeout: Dict[str, float] = {}
        self._was_stale: Dict[str, bool] = {}
        self.missed_events = 0

    def register(self, name: str, timeout_s: Optional[float] = None):
        """Start tracking ``name`` (fresh now) with its own timeout."""
        self._timeout[name] = self.default_timeout_s if timeout_s is None else float(timeout_s)
        self._last[name] = self._clock()
        self._was_stale[name] = False

    def beat(self, name: str):
        """Record progress of ``name`` (registering it on first beat)."""
        if name not in self._last:
            self.register(name)
        self._last[name] = self._clock()
        self._was_stale[name] = False

    def stale(self) -> Dict[str, float]:
        """{name: seconds since last beat} for every overdue component."""
        now = self._clock()
        out: Dict[str, float] = {}
        for name, last in self._last.items():
            age = now - last
            if age > self._timeout[name]:
                out[name] = age
                if not self._was_stale[name]:
                    self._was_stale[name] = True
                    self.missed_events += 1
        return out

    def age(self, name: str) -> float:
        """Seconds since ``name``'s last beat."""
        return self._clock() - self._last[name]

    def metrics(self, prefix: str = "heartbeat_") -> Dict[str, float]:
        """Flat gauge dict for scraping alongside the serve metrics."""
        overdue = self.stale()
        out = {
            f"{prefix}components": float(len(self._last)),
            f"{prefix}stale": float(len(overdue)),
            f"{prefix}missed_events": float(self.missed_events),
        }
        for name in self._last:
            out[sanitize_name(f"{prefix}age_s_{name}")] = self.age(name)
        return out
