"""Threshold-rule alerting over the scrape surface.

Port of ``repro/obs/alerts.py``: the standard library only, the same
behaviour and output text line for line.

``AlertRule`` is config-shaped on purpose — metric name, comparator,
threshold, consecutive-breach window, severity — so a deployment's rules are
a JSON list, not code.  ``AlertManager.evaluate`` runs the rules against one
flat ``metrics()`` dict (the scrape path calls it on every scrape) and is
**edge-triggered**: an alert fires exactly once per threshold crossing (after
``window`` consecutive breaching evaluations) and emits a single ``clear``
event on recovery — a flapping metric shows up as many fire/clear pairs, a
steady breach as one.  Events go to an optional sink callback (and the
manager's own log); ``repro_torch.obs.Obs`` wires the sink to the flight-recorder
auto-dump.

``default_serve_rules`` encodes the standing ROADMAP debt: decorrelation
probe drift (R_off/R_sum redundancy climbing), heartbeat staleness, TTFT
p99, and page-pool occupancy, targeting the uniform gauge names the services
now publish.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import operator
import os
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

log = logging.getLogger("repro_torch.obs.alerts")

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": operator.gt,
    ">=": operator.ge,
    "<": operator.lt,
    "<=": operator.le,
    "==": operator.eq,
    "!=": operator.ne,
}

SEVERITIES = ("info", "warning", "critical")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One threshold rule: fire when ``metric op threshold`` holds for
    ``window`` consecutive evaluations."""

    name: str
    metric: str
    op: str
    threshold: float
    window: int = 1
    severity: str = "warning"

    def validate(self) -> "AlertRule":
        if self.op not in _OPS:
            raise ValueError(f"alert {self.name}: unknown comparator {self.op!r} "
                             f"(one of {sorted(_OPS)})")
        if self.window < 1:
            raise ValueError(f"alert {self.name}: window must be >= 1")
        if self.severity not in SEVERITIES:
            raise ValueError(f"alert {self.name}: severity {self.severity!r} "
                             f"not in {SEVERITIES}")
        return self

    def breached(self, value: float) -> bool:
        return _OPS[self.op](float(value), float(self.threshold))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "AlertRule":
        return cls(
            name=str(d["name"]),
            metric=str(d["metric"]),
            op=str(d.get("op", ">")),
            threshold=float(d["threshold"]),
            window=int(d.get("window", 1)),
            severity=str(d.get("severity", "warning")),
        ).validate()


class _RuleState:
    __slots__ = ("breaches", "active", "fired", "cleared", "last_value")

    def __init__(self):
        self.breaches = 0
        self.active = False
        self.fired = 0
        self.cleared = 0
        self.last_value: Optional[float] = None


class AlertManager:
    """Edge-triggered evaluation of a rule set against scrape dicts."""

    def __init__(
        self,
        rules: Sequence[AlertRule] = (),
        *,
        sink: Optional[Callable[[Dict[str, Any]], None]] = None,
        clock=time.time,
    ):
        self.rules: List[AlertRule] = []
        self._state: Dict[str, _RuleState] = {}
        self.sink = sink
        self._clock = clock
        self.events_total = 0
        # monotone fire counts already mirrored into a registry Counter, so
        # publish() can inc by delta (counters reject going backwards)
        self._published_fired: Dict[str, int] = {}
        for r in rules:
            self.add_rule(r)

    @classmethod
    def from_config(
        cls, config: Union[str, Sequence[Mapping[str, Any]]], **kw
    ) -> "AlertManager":
        """Build from a list of rule dicts, a JSON string, or a JSON file
        path (``[{"name": ..., "metric": ..., "op": ">", "threshold": ...,
        "window": 1, "severity": "warning"}, ...]``)."""
        if isinstance(config, str):
            if os.path.exists(config):
                with open(config) as f:
                    config = json.load(f)
            else:
                config = json.loads(config)
        return cls([AlertRule.from_dict(d) for d in config], **kw)

    def add_rule(self, rule: AlertRule):
        rule.validate()
        if rule.name in self._state:
            raise ValueError(f"duplicate alert rule name {rule.name!r}")
        self.rules.append(rule)
        self._state[rule.name] = _RuleState()

    # -- evaluation ------------------------------------------------------------

    def evaluate(self, metrics: Mapping[str, float]) -> List[Dict[str, Any]]:
        """Run every rule against one scrape dict; returns the edge events
        (``type`` "fire" | "clear") this evaluation produced.  Metrics absent
        from the dict leave their rules untouched (no false clears while a
        component is not exporting)."""
        events: List[Dict[str, Any]] = []
        now = self._clock()
        for rule in self.rules:
            if rule.metric not in metrics:
                continue
            st = self._state[rule.name]
            v = float(metrics[rule.metric])
            st.last_value = v
            if rule.breached(v):
                st.breaches += 1
                if not st.active and st.breaches >= rule.window:
                    st.active = True
                    st.fired += 1
                    events.append(self._event("fire", rule, v, now))
            else:
                st.breaches = 0
                if st.active:
                    st.active = False
                    st.cleared += 1
                    events.append(self._event("clear", rule, v, now))
        for ev in events:
            lvl = logging.WARNING if ev["type"] == "fire" else logging.INFO
            log.log(lvl, "alert %(type)s: %(alert)s (%(metric)s=%(value)s %(op)s %(threshold)s)", ev)
            if self.sink is not None:
                self.sink(ev)
        self.events_total += len(events)
        return events

    def _event(self, typ: str, rule: AlertRule, value: float, now: float) -> Dict[str, Any]:
        return {
            "type": typ,
            "alert": rule.name,
            "metric": rule.metric,
            "op": rule.op,
            "threshold": rule.threshold,
            "value": value,
            "severity": rule.severity,
            "t": now,
        }

    # -- read side -------------------------------------------------------------

    def state(self, name: str) -> _RuleState:
        return self._state[name]

    def active(self) -> List[str]:
        return [r.name for r in self.rules if self._state[r.name].active]

    def metrics(self, prefix: str = "alerts_") -> Dict[str, float]:
        fired = sum(s.fired for s in self._state.values())
        cleared = sum(s.cleared for s in self._state.values())
        return {
            f"{prefix}rules": float(len(self.rules)),
            f"{prefix}active": float(len(self.active())),
            f"{prefix}fired_total": float(fired),
            f"{prefix}cleared_total": float(cleared),
        }

    def publish(self, registry):
        """Per-rule active/fired gauges (labelled) + the aggregate counters."""
        registry.publish(self.metrics())
        g_active = registry.gauge("alert_active", "1 while the rule is firing",
                                  labelnames=("alert",))
        g_fired = registry.gauge("alert_fired_total", "threshold crossings",
                                 labelnames=("alert",))
        # a true Counter (not a gauge): firing history survives edge-triggered
        # clears between scrapes even if the gauge view is reset or sampled
        # mid-flap — Prometheus rate() needs the monotone series
        c_fired = registry.counter("obs_alerts_fired_total",
                                   "cumulative alert firings", labelnames=("rule",))
        for rule in self.rules:
            st = self._state[rule.name]
            g_active.labels(alert=rule.name).set(1.0 if st.active else 0.0)
            g_fired.labels(alert=rule.name).set(float(st.fired))
            delta = st.fired - self._published_fired.get(rule.name, 0)
            if delta > 0:
                c_fired.labels(rule=rule.name).inc(float(delta))
                self._published_fired[rule.name] = st.fired
            elif rule.name not in self._published_fired:
                c_fired.labels(rule=rule.name).inc(0.0)
                self._published_fired[rule.name] = st.fired


def default_serve_rules() -> List[AlertRule]:
    """The ROADMAP's probe-triggered alerting debt, as config: decorr probe
    drift, heartbeat staleness, TTFT p99, and page-pool pressure."""
    return [
        AlertRule("probe_r_sum_drift", "decorr_r_sum_norm_ema", ">", 0.5,
                  window=3, severity="warning"),
        AlertRule("probe_r_off_drift", "decorr_r_off_norm_ema", ">", 0.5,
                  window=3, severity="warning"),
        AlertRule("probe_feature_variance_collapse", "decorr_feat_var_ema", "<", 1e-4,
                  window=3, severity="critical"),
        AlertRule("heartbeat_stale", "heartbeat_stale", ">", 0.0,
                  severity="critical"),
        # reads the scrape-time histogram-derived quantile gauge
        # (registry.quantile_gauges over serve_ttft_seconds buckets), not the
        # service's own rolling-window percentile — one TTFT stream of record
        AlertRule("ttft_p99_high", "serve_ttft_seconds_p99", ">", 5.0,
                  window=2, severity="warning"),
        AlertRule("page_pool_pressure", "paged_pages_utilization", ">", 0.95,
                  window=3, severity="warning"),
    ]


def default_train_rules() -> List[AlertRule]:
    """Decorrelation-health rules for the training loop, matched to the
    ``train_decorr_*`` gauges :class:`repro_torch.obs.health.DecorrHealthMonitor`
    publishes.  The relaxation-gap rule watches the FFT relaxation drifting
    away from the exact off-diagonal objective (the paper's undesirable-
    minima failure mode); the variance rules watch for feature collapse
    (Barlow-Twins/VICReg's motivating pathology).  Gap rules only evaluate
    when the probe affords the exact R_off term — absent metrics leave
    their rules untouched."""
    return [
        AlertRule("train_relaxation_gap_blowup", "train_decorr_relaxation_gap_ema",
                  ">", 0.5, window=3, severity="warning"),
        AlertRule("train_variance_collapse", "train_decorr_feat_var_ema", "<", 1e-4,
                  window=3, severity="critical"),
        AlertRule("train_feature_mean_drift", "train_decorr_feat_mean_abs_ema",
                  ">", 1.0, window=3, severity="warning"),
    ]
