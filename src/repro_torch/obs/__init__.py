"""repro_torch.obs — unified telemetry for the train + serve stack (port of
``repro/obs/`` but ``catalog``, which goes with the serving fabric).

One subsystem, one module a layer:

  * ``registry``  — typed Counter/Gauge/Histogram primitives with labels, a
                    cardinality guard, Prometheus text exposition, and a
                    process-global default registry;
  * ``tracing``   — per-request lifecycle spans (submit -> queue -> admit ->
                    prefill -> decode ticks -> retire) + pool-level
                    executable spans, exportable as Chrome ``trace_event``
                    JSON (``reconstruct_request`` rebuilds one request's
                    story from a dump);
  * ``recorder``  — the scheduler flight recorder: a bounded ring buffer of
                    per-tick events (admit/defer/retire/page moves/
                    backpressure), dumpable on demand or on alert;
  * ``alerts``    — config-driven threshold rules over the scrape surface,
                    edge-triggered (fire once per crossing, clear on
                    recovery), wired to the decorr probe gauges, heartbeat
                    ages, TTFT and page-pool occupancy;
  * ``profiling`` — opt-in ``torch.profiler`` capture behind start/stop;
  * ``perf``      — per-executable wall-time attribution (device work
                    included) joined with analytic FLOPs / bytes against the
                    H100 roofline (achieved GFLOP/s and GB/s, utilization
                    and disagreement gauges, first-call gauges, shape-cache
                    hit/miss counters);
  * ``health``    — the train-side decorrelation-health monitor (exact-vs-
                    relaxed gap, per-feature variance histograms, EMA
                    collapse indicators) feeding ``default_train_rules``;
  * ``http``      — the stdlib scrape endpoint (``/metrics`` evaluates the
                    alert rules on every scrape; ``/perf`` and ``/flight``
                    expose executable attribution and the flight recorder).

``Obs`` bundles all of it; services accept ``obs=`` and default to a fully
enabled bundle (``Obs.disabled()`` is the telemetry-off baseline).

    from repro_torch.obs import Obs
    from repro_torch.obs.alerts import AlertManager, default_serve_rules

    obs = Obs(alerts=AlertManager(default_serve_rules()))
    svc = LMService(engine, obs=obs)
    server = obs.start_server(port=9100, metrics_fn=svc.metrics)
    ...
    obs.tracer.write("trace.json")          # chrome://tracing
    obs.recorder.dump_json("flightrec.json")
"""

from repro_torch.obs.alerts import (
    AlertManager,
    AlertRule,
    default_serve_rules,
    default_train_rules,
)
from repro_torch.obs.context import Obs
from repro_torch.obs.health import DecorrHealthMonitor
from repro_torch.obs.http import MetricsServer
from repro_torch.obs.perf import ExecTimer
from repro_torch.obs.profiling import Profiler
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    quantile_from_buckets,
    sanitize_name,
)
from repro_torch.obs.tracing import RequestTrace, Tracer, reconstruct_request

__all__ = [
    "AlertManager",
    "AlertRule",
    "Counter",
    "DecorrHealthMonitor",
    "ExecTimer",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsServer",
    "Obs",
    "Profiler",
    "RequestTrace",
    "Tracer",
    "default_registry",
    "default_serve_rules",
    "default_train_rules",
    "quantile_from_buckets",
    "reconstruct_request",
    "sanitize_name",
]
