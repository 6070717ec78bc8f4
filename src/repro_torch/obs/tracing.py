"""Request tracing: span objects threaded through the serving lifecycle,
exportable as Chrome ``trace_event`` JSON (chrome://tracing / Perfetto).

Port of ``repro/obs/tracing.py``: the standard library only, the same
behaviour and output text line for line.

Two layers:

  * ``RequestTrace`` — per-request lifecycle marks (submit -> admit ->
    first token -> done, plus decode-tick counting).  It is ALWAYS created,
    even with tracing disabled, because it is the one timing source the
    service, the load generator and the bench all read (TTFT/latency come
    from these marks, not from private ``time.perf_counter()`` bookkeeping
    scattered per caller).  The marks are four floats — cheap enough to keep
    on every request at full traffic.
  * ``Tracer`` — the bounded event buffer behind it.  When enabled, each
    completed ``RequestTrace`` folds into Chrome complete ("X") spans —
    ``queue`` (submit->admit, with queue-depth attributes), ``prefill``
    (admit->first token), ``decode`` (first token->done, with the tick
    count) — on the request's own track (tid = request id), plus whatever
    pool-level executable spans (``decode_step``, ``prefill``,
    ``prefill_chunk``, ``dispatch``) the service adds.  ``write()`` dumps
    the standard ``{"traceEvents": [...]}`` JSON; ``reconstruct_request``
    rebuilds one request's lifecycle from a dump (the acceptance check: a
    single slow request must be explainable post-hoc).

Timestamps are ``time.perf_counter()`` microseconds relative to the
tracer's construction (Chrome wants monotonic us).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


class RequestTrace:
    """Lifecycle marks for one request (LM or embedding)."""

    __slots__ = ("rid", "kind", "t_submit", "t_admit", "t_first", "t_done",
                 "ticks", "status", "args", "_tracer")

    def __init__(self, rid: int, kind: str, tracer: Optional["Tracer"], **args):
        self.rid = rid
        self.kind = kind
        self.t_submit = time.perf_counter()
        self.t_admit: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self.ticks = 0
        self.status = "ok"
        self.args = args
        self._tracer = tracer

    # -- lifecycle marks -----------------------------------------------------

    def mark_admit(self, **args):
        self.t_admit = time.perf_counter()
        self.args.update(args)

    def mark_first(self):
        self.t_first = time.perf_counter()

    def tick(self):
        self.ticks += 1

    def mark_done(self, status: str = "ok"):
        self.t_done = time.perf_counter()
        self.status = status
        tr = self._tracer
        if tr is not None and tr.enabled:
            tr._emit_request(self)

    # -- derived timings (the one instrumentation path) ----------------------

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit

    @property
    def ttft_s(self) -> Optional[float]:
        return None if self.t_first is None else self.t_first - self.t_submit

    @property
    def queue_s(self) -> Optional[float]:
        return None if self.t_admit is None else self.t_admit - self.t_submit


class Tracer:
    """Bounded trace-event buffer with Chrome JSON export."""

    def __init__(self, *, enabled: bool = True, capacity: int = 65536):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._rid = 0
        self._t0 = time.perf_counter()
        self.requests_total = 0
        self.events_total = 0

    # -- low-level events ----------------------------------------------------

    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def _push(self, ev: Dict[str, Any]):
        with self._lock:
            self.events_total += 1
            self._events.append(ev)

    def add_span(self, name: str, t0: float, t1: float, *, cat: str = "serve",
                 tid: int = 0, **args):
        """One Chrome complete ("X") span from perf_counter endpoints."""
        if not self.enabled:
            return
        self._push({
            "name": name, "cat": cat, "ph": "X", "pid": 0, "tid": tid,
            "ts": self._us(t0), "dur": max(self._us(t1) - self._us(t0), 0.0),
            "args": args,
        })

    def instant(self, name: str, *, cat: str = "serve", tid: int = 0, **args):
        if not self.enabled:
            return
        self._push({
            "name": name, "cat": cat, "ph": "i", "s": "t", "pid": 0, "tid": tid,
            "ts": self._us(time.perf_counter()), "args": args,
        })

    def span(self, name: str, *, cat: str = "serve", tid: int = 0, **args):
        """Context manager sugar over ``add_span``."""
        return _SpanCtx(self, name, cat, tid, args)

    # -- request lifecycle ---------------------------------------------------

    def start_request(self, kind: str = "lm", **args) -> RequestTrace:
        """Always returns a ``RequestTrace`` (marks are the timing source of
        record even when event export is off)."""
        with self._lock:
            rid = self._rid
            self._rid += 1
            self.requests_total += 1
        return RequestTrace(rid, kind, self, **args)

    def _emit_request(self, rt: RequestTrace):
        base = dict(rt.args, request_id=rt.rid, kind=rt.kind, status=rt.status)
        t_admit = rt.t_admit if rt.t_admit is not None else rt.t_done
        self.add_span("queue", rt.t_submit, t_admit, tid=rt.rid, **base)
        if rt.t_first is not None and rt.t_admit is not None:
            self.add_span("prefill", rt.t_admit, rt.t_first, tid=rt.rid, **base)
        if rt.t_first is not None and rt.t_done is not None and rt.kind == "lm":
            self.add_span("decode", rt.t_first, rt.t_done, tid=rt.rid,
                          ticks=rt.ticks, **base)
        if rt.t_admit is not None and rt.t_done is not None and rt.kind != "lm":
            self.add_span("dispatch", rt.t_admit, rt.t_done, tid=rt.rid, **base)
        self.instant("retire", tid=rt.rid, request_id=rt.rid, status=rt.status,
                     ticks=rt.ticks)

    # -- export --------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    @property
    def dropped_events(self) -> int:
        return self.events_total - len(self._events)

    def to_chrome(self) -> Dict[str, Any]:
        with self._lock:
            events = list(self._events)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, default=float)
        return path

    def metrics(self, prefix: str = "trace_") -> Dict[str, float]:
        return {
            f"{prefix}events": float(len(self._events)),
            f"{prefix}events_total": float(self.events_total),
            f"{prefix}events_dropped": float(self.dropped_events),
            f"{prefix}requests_total": float(self.requests_total),
        }


class _SpanCtx:
    __slots__ = ("_tracer", "_name", "_cat", "_tid", "_args", "_t0")

    def __init__(self, tracer, name, cat, tid, args):
        self._tracer, self._name, self._cat, self._tid, self._args = (
            tracer, name, cat, tid, args
        )

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer.add_span(
            self._name, self._t0, time.perf_counter(),
            cat=self._cat, tid=self._tid, **self._args,
        )
        return False


def reconstruct_request(trace: Dict[str, Any], request_id: int) -> Dict[str, Any]:
    """Rebuild one request's lifecycle from a Chrome trace dump.

    Returns ``{"phases": [span names in time order], "ticks": n,
    "span_s": {name: duration seconds}, "status": ...}`` — the post-hoc
    answer to "why was request X slow".  Raises ``KeyError`` when the
    request never appears in the dump.
    """
    spans = [
        ev for ev in trace["traceEvents"]
        if ev.get("ph") == "X" and ev.get("args", {}).get("request_id") == request_id
    ]
    if not spans:
        raise KeyError(f"request {request_id} not present in trace")
    spans.sort(key=lambda ev: ev["ts"])
    ticks = max((ev["args"].get("ticks", 0) for ev in spans), default=0)
    retired = any(
        ev.get("ph") == "i" and ev.get("name") == "retire"
        and ev.get("args", {}).get("request_id") == request_id
        for ev in trace["traceEvents"]
    )
    return {
        "phases": [ev["name"] for ev in spans],
        "ticks": int(ticks),
        "span_s": {ev["name"]: ev["dur"] / 1e6 for ev in spans},
        "status": spans[-1]["args"].get("status", "ok"),
        "retired": retired,
    }
