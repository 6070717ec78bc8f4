"""Fault-tolerance runtime, port of ``repro/ft/watchdog.py``: straggler
detection, liveness heartbeats, preemption flags, transient-failure retry.

The heartbeat store is process-local; the policy logic (rolling-median
step-time outliers, preemption-flag draining, bounded retry with backoff)
is what a multi-host loop runs too.
"""

from __future__ import annotations

import os
import re
import time
from collections import deque
from typing import Callable, Dict, Optional

_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    """Map an arbitrary gauge key onto the Prometheus metric-name grammar."""
    out = _INVALID.sub("_", str(name))
    if not out or out[0].isdigit():
        out = "_" + out
    return out


class StragglerWatchdog:
    """Flags steps slower than ``factor`` x the rolling median of the last
    ``window`` steps (once ``min_samples`` are in); counts them."""

    def __init__(self, window: int = 32, factor: float = 3.0, min_samples: int = 8):
        self.durations: deque = deque(maxlen=window)
        self.factor = factor
        self.min_samples = min_samples
        self.straggler_events = 0
        self._t0: Optional[float] = None

    def step_start(self):
        """Mark the start of a step."""
        self._t0 = time.perf_counter()

    def step_end(self) -> bool:
        """Close the step; True if it was a straggler."""
        dt = time.perf_counter() - self._t0
        is_straggler = False
        if len(self.durations) >= self.min_samples:
            med = sorted(self.durations)[len(self.durations) // 2]
            if dt > self.factor * med:
                self.straggler_events += 1
                is_straggler = True
        self.durations.append(dt)
        return is_straggler

    @property
    def median(self) -> float:
        """Median step time of the window (0 before the first step)."""
        if not self.durations:
            return 0.0
        return sorted(self.durations)[len(self.durations) // 2]


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

    def publish_metrics(self, registry, prefix: str = "heartbeat_") -> set:
        """Registry view of the scrape surface: ONE labelled age gauge
        (``heartbeat_age_s{name="serve.dispatch"}``) instead of a metric
        family per component, plus the flat aggregate gauges.  Returns the
        legacy name-suffixed keys this publish claims: they stay in the
        ``metrics()`` dict view, and the caller
        (``serve.service.collect_metrics``) must not also publish them flat."""
        m = self.metrics(prefix)
        gauge = registry.gauge(f"{prefix}age_s", "seconds since a component's last heartbeat", labelnames=("name",))
        claimed = set()
        for name in self._last:
            gauge.labels(name=name).set(self.age(name))
            claimed.add(sanitize_name(f"{prefix}age_s_{name}"))
        registry.publish({k: v for k, v in m.items() if k not in claimed})
        return claimed


class PreemptionSignal:
    """File-flag preemption notice (a SIGTERM handler writes it; tests touch
    it).  The train loop checks it every step and exits through a final
    checkpoint when it is raised."""

    def __init__(self, flag_path: str):
        self.flag_path = flag_path

    def raised(self) -> bool:
        """True while the flag file exists."""
        return os.path.exists(self.flag_path)

    def set(self):
        """Raise the flag."""
        with open(self.flag_path, "w") as f:
            f.write("preempt")

    def clear(self):
        """Lower the flag."""
        if os.path.exists(self.flag_path):
            os.remove(self.flag_path)


def with_retries(
    fn: Callable,
    max_retries: int = 3,
    backoff_s: float = 0.05,
    retryable=(RuntimeError,),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """Bounded-retry wrapper for transient device / step failures, with
    exponential backoff.  Safe for a train step only if a failed attempt
    leaves the state untouched (``train/ssl.py`` updates the parameters
    after the gradients are complete)."""

    def wrapped(*args, **kwargs):
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except retryable as e:
                attempt += 1
                if attempt > max_retries:
                    raise
                if on_retry:
                    on_retry(attempt, e)
                time.sleep(backoff_s * (2 ** (attempt - 1)))

    return wrapped
