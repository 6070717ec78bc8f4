"""Scheduler flight recorder: a bounded ring buffer of per-tick events.

Port of ``repro/obs/recorder.py``: the standard library only, the same
behaviour and output text line for line.

The continuous-batching scheduler makes dozens of micro-decisions per tick
(admit, defer, retire, page binds, compaction moves); when something goes
wrong — a stall, an OOM-shaped deferral pile-up, a probe drift alert — the
aggregate gauges say *that* it happened but not *what the scheduler was
doing*.  The recorder keeps the last N events (ring buffer, O(1) append,
drop-oldest) so the window leading up to an anomaly is always dumpable:
on demand (``dump`` / ``dump_json``) or automatically when an alert fires
(``repro_torch.obs.Obs`` wires the alert sink to ``dump_json``).

``capacity=0`` disables recording entirely (the telemetry-off bench path);
``record`` is then a no-op costing one attribute read.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


class FlightRecorder:
    """Bounded ring buffer of ``(seq, t, kind, fields)`` events."""

    def __init__(self, capacity: int = 4096, clock=time.perf_counter):
        self.capacity = int(capacity)
        self.enabled = self.capacity > 0
        self._clock = clock
        self._ring: deque = deque(maxlen=max(self.capacity, 1))
        self._lock = threading.Lock()
        self.recorded_total = 0

    def record(self, kind: str, **fields):
        if not self.enabled:
            return
        with self._lock:
            self._ring.append((self.recorded_total, self._clock(), kind, fields))
            self.recorded_total += 1

    # -- read side ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._ring) if self.enabled else 0

    @property
    def dropped(self) -> int:
        return self.recorded_total - len(self)

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        """Oldest-first event dicts, optionally filtered by kind."""
        with self._lock:
            rows = list(self._ring) if self.enabled else []
        return [
            {"seq": seq, "t": t, "kind": k, **fields}
            for seq, t, k, fields in rows
            if kind is None or k == kind
        ]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events():
            out[ev["kind"]] = out.get(ev["kind"], 0) + 1
        return out

    def clear(self):
        with self._lock:
            self._ring.clear()

    # -- dumps -----------------------------------------------------------------

    def dump(self) -> Dict[str, Any]:
        return {
            "capacity": self.capacity,
            "recorded_total": self.recorded_total,
            "dropped": self.dropped,
            "events": self.events(),
        }

    def dump_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.dump(), f, default=float)
        return path

    def metrics(self, prefix: str = "flightrec_") -> Dict[str, float]:
        return {
            f"{prefix}events": float(len(self)),
            f"{prefix}recorded_total": float(self.recorded_total),
            f"{prefix}dropped": float(self.dropped),
        }
