"""The ``Obs`` bundle: one object carrying the whole telemetry stack (port
of ``repro/obs/context.py``).

Every service takes an optional ``obs``; the default is a fully-enabled
bundle (registry + tracer + flight recorder + alert manager + profiler), and
``Obs.disabled()`` is the telemetry-off configuration the overhead bench
compares against (event export, recording and step-time histograms all
skipped on the hot path; the registry still exists so ``metrics()`` keeps
its compatibility contract either way).

``scrape()`` is the exposition entry point the HTTP endpoint calls: refresh
the gauges (via the bound ``metrics_fn``), evaluate the alert rules on the
fresh values, publish alert state, auto-dump the flight recorder when a rule
fires (``dump_dir``), and render the registry as Prometheus text.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs.alerts import AlertManager
from repro_torch.obs.http import MetricsServer
from repro_torch.obs.perf import ExecTimer
from repro_torch.obs.profiling import Profiler
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.tracing import Tracer


class Obs:
    """Registry + tracer + flight recorder + alerts + profiler, one handle."""

    def __init__(
        self,
        *,
        enabled: bool = True,
        registry: Optional[MetricsRegistry] = None,
        tracer: Optional[Tracer] = None,
        recorder: Optional[FlightRecorder] = None,
        alerts: Optional[AlertManager] = None,
        profiler: Optional[Profiler] = None,
        perf: Optional[ExecTimer] = None,
        dump_dir: Optional[str] = None,
        recorder_capacity: int = 4096,
    ):
        self.enabled = bool(enabled)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(enabled=enabled)
        self.recorder = recorder if recorder is not None else FlightRecorder(
            capacity=recorder_capacity if enabled else 0
        )
        self.alerts = alerts if alerts is not None else AlertManager()
        self.profiler = profiler if profiler is not None else Profiler()
        self.perf = perf if perf is not None else ExecTimer(self.registry, enabled=enabled)
        self.dump_dir = dump_dir
        self._dumps = 0

    @classmethod
    def disabled(cls) -> "Obs":
        """Telemetry-off: no trace events, no flight recording, no step-time
        histogram observes.  The registry (and ``metrics()``) still work."""
        return cls(enabled=False)

    # -- scrape path -----------------------------------------------------------

    def check_alerts(self, metrics: Dict[str, float]) -> List[Dict[str, Any]]:
        """Evaluate the rules on one scrape dict; publish alert gauges; dump
        the flight recorder on every newly-fired alert (anomaly auto-dump)."""
        events = self.alerts.evaluate(metrics)
        self.alerts.publish(self.registry)
        if self.dump_dir:
            for ev in events:
                if ev["type"] != "fire" or not self.recorder.enabled:
                    continue
                os.makedirs(self.dump_dir, exist_ok=True)
                self._dumps += 1
                self.recorder.dump_json(os.path.join(
                    self.dump_dir, f"flightrec_{ev['alert']}_{self._dumps}.json"
                ))
        return events

    def scrape(self, metrics_fn: Optional[Callable[[], Dict[str, float]]] = None) -> str:
        """Refresh -> alert -> render.  ``metrics_fn`` is typically a
        service's ``metrics`` (which republishes its gauges as a side
        effect); without one, rules run over the registry's current view."""
        if metrics_fn is not None:
            m = dict(metrics_fn())
            self.registry.publish(m)  # idempotent for callers that publish
        else:
            m = self.registry.as_dict()
        # derive histogram-quantile gauges (serve_ttft_seconds_p99, ...) from
        # bucket counts BEFORE rule evaluation, so alert rules read the same
        # stream the service observes into — not a parallel percentile gauge
        derived = self.registry.quantile_gauges()
        if derived:
            self.registry.publish(derived)
            m.update(derived)
        # per-executable roofline gauges (exec_roofline_utilization{...}) are
        # derived views over the perf stats, refreshed like quantile gauges
        self.perf.publish(self.registry)
        m.update(self.perf.metrics())
        self.check_alerts(m)
        return self.registry.exposition()

    def start_server(
        self,
        port: int = 0,
        metrics_fn: Optional[Callable[[], Dict[str, float]]] = None,
        host: str = "127.0.0.1",
    ) -> MetricsServer:
        """Serve ``/metrics`` (exposition + alert evaluation), ``/alerts``,
        ``/perf`` (executable attribution), ``/flight`` (recent flight-
        recorder events) and ``/healthz`` on a daemon thread; returns the
        started server (read ``.port`` when asking for an ephemeral one)."""
        return MetricsServer(
            lambda: self.scrape(metrics_fn),
            alerts_fn=lambda: [
                {"alert": n, **vars_of(self.alerts.state(n))} for n in self.alerts.active()
            ],
            perf_fn=self.perf.report,
            flight_fn=self.recorder.dump,
            host=host,
            port=port,
        ).start()

    # -- the bundle's own gauges ----------------------------------------------

    def metrics(self) -> Dict[str, float]:
        out = {"obs_enabled": 1.0 if self.enabled else 0.0}
        out.update(self.tracer.metrics())
        out.update(self.recorder.metrics())
        out.update(self.alerts.metrics())
        out.update(self.profiler.metrics())
        out.update(self.perf.metrics())
        return out


def vars_of(state) -> Dict[str, Any]:
    """__slots__-safe vars() for alert rule state."""
    return {k: getattr(state, k) for k in state.__slots__}
