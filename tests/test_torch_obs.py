"""``repro_torch.obs`` — the port's telemetry stack, on the CPU.

Twins of ``tests/test_obs.py`` (all but the two that parse XLA's HLO, whose
PyTorch counterpart goes with the launch analysis tools): the registry's
types, exposition grammar and quantiles, edge-triggered alerts, the flight
recorder, the tracer, the ``Obs`` bundle and its HTTP endpoint,
``ExecTimer``, the decorrelation-health monitor, the train loop's hooks and
the services' telemetry (the reduced ``gemma2-2b`` LM service, the
embedding service).  Where the reference can produce the same text from the
same operations — the Prometheus exposition, the Chrome trace JSON (a
stepped clock in place of ``time.perf_counter``), the flight recorder's
dump and the alert events — the port's string must equal it exactly.
"""

import itertools
import json
import math
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as ref_obs  # noqa: E402
import repro_torch.obs as port_obs  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    AlertManager,
    AlertRule,
    DecorrHealthMonitor,
    ExecTimer,
    FlightRecorder,
    MetricsRegistry,
    Obs,
    Profiler,
    Tracer,
    default_serve_rules,
    default_train_rules,
    quantile_from_buckets,
    reconstruct_request,
    sanitize_name,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (see tests/test_torch_lm_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _monitor(**kw):
    # ema=0 -> every indicator tracks the latest batch exactly
    kw.setdefault("ema", 0.0)
    return DecorrHealthMonitor(device="cpu", **kw)


# ---------------------------------------------------------------------------
# Registry primitives
# ---------------------------------------------------------------------------


class TestRegistry:
    def test_counter_monotone(self):
        reg = MetricsRegistry()
        c = reg.counter("requests_total")
        c.inc()
        c.inc(2.5)
        assert c.value == 3.5
        with pytest.raises(ValueError):
            c.inc(-1)

    def test_gauge_set_inc_dec(self):
        g = MetricsRegistry().gauge("depth")
        g.set(4)
        g.inc()
        g.dec(2)
        assert g.value == 3.0

    def test_histogram_bucket_boundaries(self):
        h = MetricsRegistry().histogram("lat", buckets=(0.1, 1.0, 10.0))
        for v in (0.1, 0.05, 0.5, 5.0, 50.0):  # 0.1 lands IN le=0.1 (<=)
            h.observe(v)
        cum = h._default_child().bucket_counts()
        assert [(le, c) for le, c in cum] == [(0.1, 2), (1.0, 3), (10.0, 4), (math.inf, 5)]
        assert h.count == 5 and h.sum == pytest.approx(55.65)

    def test_histogram_rejects_bad_buckets(self):
        reg = MetricsRegistry()
        with pytest.raises(ValueError):
            reg.histogram("h1", buckets=())
        with pytest.raises(ValueError):
            reg.histogram("h2", buckets=(1.0, 1.0))

    def test_label_cardinality_guard(self):
        reg = MetricsRegistry(max_label_sets=3)
        c = reg.counter("hits", labelnames=("path",))
        for i in range(3):
            c.labels(path=f"/p{i}").inc()
        c.labels(path="/p0").inc()  # existing set: fine
        with pytest.raises(ValueError, match="cardinality"):
            c.labels(path="/p3")

    def test_type_conflict_raises(self):
        reg = MetricsRegistry()
        reg.counter("x")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x")
        with pytest.raises(ValueError, match="labelnames"):
            reg.counter("x", labelnames=("a",))

    def test_sanitize_name(self):
        assert sanitize_name("heartbeat_age_s:serve.dispatch") == "heartbeat_age_s_serve_dispatch"
        assert sanitize_name("9lives") == "_9lives"

    def test_publish_and_value(self):
        reg = MetricsRegistry()
        reg.publish({"tok_per_s": 12.5, "decorr.r_off": 0.1})
        assert reg.value("tok_per_s") == 12.5
        assert reg.value("decorr_r_off") == 0.1
        assert reg.value("missing") is None

    def test_exposition_round_trip(self):
        reg = MetricsRegistry()
        reg.counter("served_total", "requests served").inc(7)
        reg.gauge("queue_depth").set(3)
        reg.histogram("step_s", buckets=(0.5,)).observe(0.2)
        g = reg.gauge("err", labelnames=("kind",))
        g.labels(kind='dev"ice\n').set(1)
        text = reg.exposition()
        assert "# HELP served_total requests served" in text
        assert "# TYPE served_total counter" in text
        assert "served_total 7" in text.splitlines()
        assert 'step_s_bucket{le="0.5"} 1' in text
        assert 'step_s_bucket{le="+Inf"} 1' in text
        assert "step_s_count 1" in text.splitlines()
        assert 'err{kind="dev\\"ice\\n"} 1' in text.splitlines()
        for line in text.splitlines():
            if line.startswith("#") or not line:
                continue
            name, value = line.rsplit(" ", 1)
            float(value.replace("+Inf", "inf"))
            assert sanitize_name(name.split("{")[0]) == name.split("{")[0]

    def test_as_dict_matches_values(self):
        reg = MetricsRegistry()
        reg.publish({"a": 1.0, "b": 2.0})
        reg.histogram("h").observe(0.3)
        d = reg.as_dict()
        assert d["a"] == 1.0 and d["b"] == 2.0
        assert d["h_count"] == 1.0 and "h_bucket" not in str(sorted(d))

    def test_quantile_from_buckets_interpolates(self):
        bounds = (1.0, 2.0, 4.0)
        counts = (2, 2, 0, 0)
        assert quantile_from_buckets(bounds, counts, 0.5) == pytest.approx(1.0)
        assert quantile_from_buckets(bounds, counts, 0.25) == pytest.approx(0.5)
        assert quantile_from_buckets(bounds, counts, 0.75) == pytest.approx(1.5)
        assert quantile_from_buckets(bounds, counts, 1.0) == pytest.approx(2.0)

    def test_quantile_from_buckets_edges(self):
        assert quantile_from_buckets((1.0, 2.0), (0, 0, 0), 0.99) == 0.0
        assert quantile_from_buckets((1.0, 2.0), (0, 0, 5), 0.99) == 2.0
        with pytest.raises(ValueError, match="quantile"):
            quantile_from_buckets((1.0,), (1, 0), 1.5)
        with pytest.raises(ValueError, match="quantile"):
            quantile_from_buckets((1.0,), (1, 0), -0.1)

    def test_quantile_from_buckets_single_bucket(self):
        assert quantile_from_buckets((2.0,), (4, 0), 0.0) == pytest.approx(0.0)
        assert quantile_from_buckets((2.0,), (4, 0), 0.5) == pytest.approx(1.0)
        assert quantile_from_buckets((2.0,), (4, 0), 1.0) == pytest.approx(2.0)
        assert quantile_from_buckets((2.0,), (1, 0), 1.0) == pytest.approx(2.0)

    def test_label_cardinality_overflow_keeps_existing_children(self):
        reg = MetricsRegistry(max_label_sets=2)
        c = reg.counter("hits", labelnames=("path",))
        c.labels(path="/a").inc()
        c.labels(path="/b").inc(2)
        with pytest.raises(ValueError, match="cardinality"):
            c.labels(path="/c")
        c.labels(path="/a").inc()
        assert reg.value("hits", {"path": "/a"}) == 2.0
        assert reg.value("hits", {"path": "/b"}) == 2.0
        text = reg.exposition()
        assert 'hits{path="/a"} 2' in text and 'hits{path="/c"}' not in text
        with pytest.raises(ValueError, match="cardinality"):
            c.labels(path="/c")

    def test_histogram_quantile_and_derived_gauges(self):
        reg = MetricsRegistry()
        h = reg.histogram("step_s", buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.2, 0.4, 0.9, 20.0):
            h.observe(v)
        assert 0.1 < h.quantile(0.5) < 1.0
        derived = reg.quantile_gauges()
        assert derived["step_s_p50"] == pytest.approx(h.quantile(0.5))
        assert derived["step_s_p99"] == 10.0
        lab = reg.histogram("lat_s", labelnames=("path",))
        lab.labels(path="/a").observe(0.3)
        reg.gauge("depth").set(2)
        assert set(reg.quantile_gauges()) == {"step_s_p50", "step_s_p99"}

    def test_scrape_derives_quantiles_and_fires_ttft_alert(self):
        obs = Obs(alerts=AlertManager(default_serve_rules()))
        h = obs.registry.histogram("serve_ttft_seconds", "ttft")
        for _ in range(4):
            h.observe(30.0)
        rule = next(r for r in default_serve_rules() if r.name == "ttft_p99_high")
        for _ in range(rule.window):
            obs.scrape()
        assert "ttft_p99_high" in obs.alerts.active()
        assert obs.registry.value("serve_ttft_seconds_p99") > 5.0


# ---------------------------------------------------------------------------
# The same operations, the same text as the reference
# ---------------------------------------------------------------------------


def _registry_ops(obs):
    reg = obs.MetricsRegistry(max_label_sets=4)
    reg.counter("served_total", "requests served").inc(7)
    reg.gauge("queue_depth").set(3)
    h = reg.histogram("step_s", "step time", buckets=(0.01, 0.1, 0.5))
    for v in (0.003, 0.02, 0.2, 0.7, 0.05, 1e-4):
        h.observe(v)
    g = reg.gauge("err", labelnames=("kind",))
    g.labels(kind='dev"ice\n').set(1)
    g.labels(kind="host").set(0.125)
    lat = reg.histogram("lat_s", labelnames=("path",))
    for i, v in enumerate((0.3, 2e-3, 7.0, 42.0)):
        lat.labels(path=f"/p{i % 2}").observe(v)
    reg.publish({"tok_per_s": 12.5, "decorr.r_off": 0.1, "big": 1e16, "tiny": 3.25e-7})
    reg.publish(reg.quantile_gauges())
    return reg.exposition(), json.dumps(reg.as_dict(), sort_keys=True)


def test_exposition_equals_the_references():
    assert _registry_ops(port_obs) == _registry_ops(ref_obs)


@pytest.fixture
def stepped_clock(monkeypatch):
    """``time.perf_counter`` replaced by a clock that advances 1.5 ms a
    read, restarted for each side of a comparison."""

    def restart():
        ticks = itertools.count()
        monkeypatch.setattr(time, "perf_counter", lambda: 1000.0 + 1.5e-3 * next(ticks))

    return restart


def _trace_ops(obs):
    t = obs.Tracer(capacity=64)
    rt = t.start_request("lm", prompt_len=8)
    rt.mark_admit(slot=0, queue_depth=2)
    rt.mark_first()
    for _ in range(3):
        rt.tick()
    rt.mark_done()
    er = t.start_request("embed", rows=4)
    er.mark_admit(batch=1)
    er.mark_done("error")
    with t.span("decode_step", cat="exec", lanes=4):
        pass
    t.add_span("prefill_chunk", 1000.0, 1000.25, cat="exec", slot=1, offset=0, wrote=16)
    t.instant("retire", request_id=0)
    return json.dumps(t.to_chrome(), default=float), json.dumps(t.metrics(), sort_keys=True)


def test_chrome_trace_equals_the_references(stepped_clock):
    stepped_clock()
    port = _trace_ops(port_obs)
    stepped_clock()
    ref = _trace_ops(ref_obs)
    assert port == ref


def _alert_ops(obs):
    events = []
    rules = obs.default_serve_rules() + obs.default_train_rules() + [obs.AlertRule("w", "m", "<=", 1.0, window=2)]
    am = obs.AlertManager(rules, sink=events.append, clock=lambda: 1234.5)
    streams = [
        {"decorr_r_sum_norm_ema": 0.9, "m": 0.5, "train_decorr_feat_var_ema": 1e-6},
        {"decorr_r_sum_norm_ema": 0.9, "m": 0.5},
        {"decorr_r_sum_norm_ema": 0.9, "m": 3.0, "train_decorr_feat_var_ema": 1e-6},
        {"decorr_r_sum_norm_ema": 0.0, "heartbeat_stale": 2.0, "train_decorr_feat_var_ema": 1e-6},
        {"heartbeat_stale": 2.0, "serve_ttft_seconds_p99": 9.0, "m": 0.0},
        {"serve_ttft_seconds_p99": 9.0, "m": 0.0, "train_decorr_feat_var_ema": 1.0},
    ]
    for m in streams:
        am.evaluate(m)
    reg = obs.MetricsRegistry()
    am.publish(reg)
    return (json.dumps(events, sort_keys=True, default=str), reg.exposition(), am.active(),
            json.dumps(am.metrics(), sort_keys=True))


def test_alert_events_equal_the_references():
    assert _alert_ops(port_obs) == _alert_ops(ref_obs)


def _flight_ops(obs):
    clock = itertools.count()
    rec = obs.FlightRecorder(capacity=4, clock=lambda: float(next(clock)))
    for i in range(6):
        rec.record("tick" if i % 2 else "admit", i=i, slot=i % 3)
    return json.dumps(rec.dump(), sort_keys=True), rec.counts(), json.dumps(rec.metrics(), sort_keys=True)


def test_flight_dump_equals_the_references():
    assert _flight_ops(port_obs) == _flight_ops(ref_obs)


# ---------------------------------------------------------------------------
# Alerts: edge-triggered threshold rules
# ---------------------------------------------------------------------------


class TestAlerts:
    def test_fire_once_per_crossing_and_clear(self):
        events = []
        am = AlertManager([AlertRule("drift", "m", ">", 1.0)], sink=events.append)
        for v in (2.0, 3.0, 4.0):
            am.evaluate({"m": v})
        assert [e["type"] for e in events] == ["fire"]
        am.evaluate({"m": 0.5})
        am.evaluate({"m": 0.5})
        assert [e["type"] for e in events] == ["fire", "clear"]
        am.evaluate({"m": 9.0})
        assert [e["type"] for e in events] == ["fire", "clear", "fire"]
        st = am.state("drift")
        assert st.fired == 2 and st.cleared == 1

    def test_window_needs_consecutive_breaches(self):
        events = []
        am = AlertManager([AlertRule("w", "m", ">", 1.0, window=3)], sink=events.append)
        am.evaluate({"m": 2.0})
        am.evaluate({"m": 2.0})
        am.evaluate({"m": 0.0})
        am.evaluate({"m": 2.0})
        am.evaluate({"m": 2.0})
        assert events == []
        am.evaluate({"m": 2.0})
        assert [e["type"] for e in events] == ["fire"]

    def test_missing_metric_leaves_rule_untouched(self):
        events = []
        am = AlertManager([AlertRule("a", "m", ">", 1.0)], sink=events.append)
        am.evaluate({"m": 5.0})
        am.evaluate({"other": 0.0})
        assert [e["type"] for e in events] == ["fire"]
        assert am.active() == ["a"]

    def test_from_config_and_validation(self, tmp_path):
        rules = [{"name": "r1", "metric": "m", "op": "<", "threshold": 0.1, "window": 2, "severity": "critical"}]
        am = AlertManager.from_config(json.dumps(rules))
        assert am.rules[0].severity == "critical"
        path = tmp_path / "alerts.json"
        path.write_text(json.dumps(rules))
        assert AlertManager.from_config(str(path)).rules[0].window == 2
        with pytest.raises(ValueError, match="comparator"):
            AlertRule("bad", "m", "~", 1.0).validate()
        with pytest.raises(ValueError, match="duplicate"):
            AlertManager([AlertRule("x", "m", ">", 1), AlertRule("x", "m", ">", 2)])

    def test_publish_labelled_gauges(self):
        reg = MetricsRegistry()
        am = AlertManager([AlertRule("drift", "m", ">", 1.0)])
        am.evaluate({"m": 2.0})
        am.publish(reg)
        assert reg.value("alert_active", {"alert": "drift"}) == 1.0
        assert reg.value("alert_fired_total", {"alert": "drift"}) == 1.0
        assert reg.value("alerts_active") == 1.0

    def test_fired_counter_survives_clears_between_scrapes(self):
        reg = MetricsRegistry()
        am = AlertManager([AlertRule("flap", "m", ">", 1.0)])
        am.publish(reg)
        assert reg.value("obs_alerts_fired_total", {"rule": "flap"}) == 0.0
        for _ in range(3):
            am.evaluate({"m": 5.0})
            am.evaluate({"m": 0.0})
        am.publish(reg)
        assert reg.value("alert_active", {"alert": "flap"}) == 0.0
        assert reg.value("obs_alerts_fired_total", {"rule": "flap"}) == 3.0
        am.publish(reg)
        assert reg.value("obs_alerts_fired_total", {"rule": "flap"}) == 3.0

    def test_default_train_rules_target_health_gauges(self):
        rules = {r.name: r for r in default_train_rules()}
        assert rules["train_variance_collapse"].metric == "train_decorr_feat_var_ema"
        assert rules["train_variance_collapse"].severity == "critical"
        assert rules["train_relaxation_gap_blowup"].metric == "train_decorr_relaxation_gap_ema"
        for r in rules.values():
            r.validate()

    def test_default_serve_rules_target_live_gauges(self):
        names = {r.metric for r in default_serve_rules()}
        assert "decorr_r_sum_norm_ema" in names
        assert "heartbeat_stale" in names
        assert "serve_ttft_seconds_p99" in names
        assert "paged_pages_utilization" in names


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------


class TestFlightRecorder:
    def test_ring_wraparound_keeps_newest(self):
        rec = FlightRecorder(capacity=4)
        for i in range(10):
            rec.record("tick", i=i)
        assert len(rec) == 4 and rec.recorded_total == 10 and rec.dropped == 6
        evs = rec.events()
        assert [e["i"] for e in evs] == [6, 7, 8, 9]
        assert [e["seq"] for e in evs] == [6, 7, 8, 9]

    def test_disabled_recorder_is_noop(self):
        rec = FlightRecorder(capacity=0)
        rec.record("tick")
        assert len(rec) == 0 and rec.events() == [] and not rec.enabled

    def test_filter_counts_dump(self, tmp_path):
        rec = FlightRecorder(capacity=16)
        rec.record("admit", slot=0)
        rec.record("retire", slot=0)
        rec.record("admit", slot=1)
        assert rec.counts() == {"admit": 2, "retire": 1}
        assert [e["slot"] for e in rec.events("admit")] == [0, 1]
        path = rec.dump_json(str(tmp_path / "fr.json"))
        dump = json.loads(open(path).read())
        assert dump["recorded_total"] == 3 and len(dump["events"]) == 3


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------


class TestTracer:
    def test_request_lifecycle_spans(self):
        t = Tracer()
        rt = t.start_request("lm", prompt_len=8)
        rt.mark_admit(slot=0)
        rt.mark_first()
        rt.tick()
        rt.tick()
        rt.tick()
        rt.mark_done()
        rec = reconstruct_request(t.to_chrome(), rt.rid)
        assert rec["phases"] == ["queue", "prefill", "decode"]
        assert rec["ticks"] == 3 and rec["retired"] and rec["status"] == "ok"
        assert rt.latency_s >= rt.ttft_s >= rt.queue_s >= 0

    def test_reconstruct_missing_request_raises(self):
        with pytest.raises(KeyError):
            reconstruct_request(Tracer().to_chrome(), 99)

    def test_disabled_tracer_marks_still_time(self):
        t = Tracer(enabled=False)
        rt = t.start_request("lm")
        rt.mark_admit()
        rt.mark_first()
        rt.mark_done()
        assert rt.latency_s is not None
        assert len(t) == 0

    def test_write_chrome_json(self, tmp_path):
        t = Tracer()
        with t.span("decode_step", lanes=4):
            pass
        t.instant("retire", request_id=0)
        path = t.write(str(tmp_path / "trace.json"))
        dump = json.loads(open(path).read())
        assert [e["name"] for e in dump["traceEvents"]] == ["decode_step", "retire"]
        assert dump["traceEvents"][0]["ph"] == "X"

    def test_bounded_buffer_drops_oldest(self):
        t = Tracer(capacity=2)
        for i in range(5):
            t.instant("e", i=i)
        assert len(t) == 2 and t.dropped_events == 3


# ---------------------------------------------------------------------------
# Obs bundle + HTTP endpoint + profiler
# ---------------------------------------------------------------------------


class TestObsBundle:
    def test_scrape_evaluates_rules_and_dumps_recorder(self, tmp_path):
        obs = Obs(alerts=AlertManager(default_serve_rules()), dump_dir=str(tmp_path))
        obs.recorder.record("tick", i=1)
        bad = {"decorr_r_sum_norm_ema": 0.9}
        for _ in range(3):
            text = obs.scrape(lambda: bad)
        assert obs.alerts.active() == ["probe_r_sum_drift"]
        dumps = list(tmp_path.glob("flightrec_probe_r_sum_drift_*.json"))
        assert len(dumps) == 1
        assert json.loads(dumps[0].read_text())["events"][0]["kind"] == "tick"
        assert 'alert_active{alert="probe_r_sum_drift"} 1' in text
        obs.scrape(lambda: {"decorr_r_sum_norm_ema": 0.0})
        assert obs.alerts.active() == []

    def test_disabled_obs_turns_hot_paths_off(self):
        obs = Obs.disabled()
        assert not obs.tracer.enabled and not obs.recorder.enabled
        rt = obs.tracer.start_request("lm")
        rt.mark_done()
        assert rt.latency_s is not None and len(obs.tracer) == 0
        assert obs.metrics()["obs_enabled"] == 0.0

    def test_http_endpoint(self):
        obs = Obs(alerts=AlertManager([AlertRule("a", "m", ">", 1.0)]))
        server = obs.start_server(port=0, metrics_fn=lambda: {"m": 5.0})
        try:
            base = server.url
            text = urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
            assert "m 5" in text and "alerts_fired_total 1" in text
            alerts = json.loads(urllib.request.urlopen(base + "/alerts", timeout=10).read())
            assert alerts[0]["alert"] == "a" and alerts[0]["active"]
            assert urllib.request.urlopen(base + "/healthz", timeout=10).read() == b"ok\n"
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(base + "/nope", timeout=10)
        finally:
            server.stop()

    def test_profiler_noop_without_dir(self):
        p = Profiler()
        assert p.start() is False and p.stop() is None
        assert p.metrics()["profiler_active"] == 0.0

    def test_perf_and_flight_endpoints(self):
        obs = Obs()
        obs.perf.attach_analysis("decode", flops=2e9, hbm_bytes=1e8)
        obs.perf.observe("decode", 0.004)
        obs.perf.observe("decode", 0.002)
        obs.recorder.record("admit", slot=1)
        server = obs.start_server(port=0)
        try:
            base = server.url
            perf = json.loads(urllib.request.urlopen(base + "/perf", timeout=10).read())
            assert perf["executables"] == 1 and perf["observed_total"] == 2
            row = perf["top"][0]
            assert row["executable"] == "decode" and row["calls"] == 2
            assert 0.0 < row["roofline_utilization"] <= 1.0
            assert row["best_s"] == pytest.approx(0.002)
            flight = json.loads(urllib.request.urlopen(base + "/flight", timeout=10).read())
            assert flight["recorded_total"] == 1
            assert flight["events"][0]["kind"] == "admit"
            urllib.request.urlopen(base + "/metrics", timeout=10).read()
            assert obs.registry.value("exec_roofline_utilization", {"executable": "decode"}) == pytest.approx(
                row["roofline_utilization"])
        finally:
            server.stop()


def test_profiler_captures_a_chrome_trace_on_the_cpu(tmp_path):
    """The port's profiler: CPU activity, a Chrome trace file per session
    naming the ops run inside it; a second start while active refuses."""
    p = Profiler(str(tmp_path))
    assert p.start() is True and p.start() is False
    torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    path = p.stop()
    assert path is not None and path.endswith("trace_0.json")
    assert "aten::mm" in open(path).read()
    assert p.metrics() == {"profiler_active": 0.0, "profiler_sessions_total": 1.0, "profiler_errors_total": 0.0}


# ---------------------------------------------------------------------------
# ExecTimer
# ---------------------------------------------------------------------------


class TestExecTimer:
    def test_observe_tracks_calls_total_best(self):
        t = ExecTimer()
        for s in (0.03, 0.01, 0.02):
            t.observe("step", s)
        (row,) = t.snapshot()
        assert row["calls"] == 3
        assert row["total_s"] == pytest.approx(0.06)
        assert row["best_s"] == pytest.approx(0.01)
        assert row["mean_s"] == pytest.approx(0.02)
        assert "roofline_utilization" not in row
        assert t.registry.get("exec_seconds").labels(executable="step").count == 3

    def test_analysis_join_derives_roofline_fields(self):
        t = ExecTimer()
        t.attach_analysis("step", flops=1e9, hbm_bytes=4e6, compile_s=0.5)
        t.observe("step", 1e-3)
        (row,) = t.snapshot()
        assert row["achieved_gflops"] == pytest.approx(1e9 / 1e-3 / 1e9)
        assert row["achieved_gbps"] == pytest.approx(4e6 / 1e-3 / 1e9)
        assert 0.0 < row["roofline_utilization"] <= 1.0
        # the H100 bound: max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s)
        assert row["bound_s"] == pytest.approx(max(4e6 / 3.35e12, 1e9 / 67e12))
        assert row["disagreement"] == pytest.approx(1e-3 / row["bound_s"])
        assert row["compile_s"] == 0.5
        assert row["dominant"] == "compute"

    def test_utilization_clamps_to_one(self):
        t = ExecTimer()
        t.attach_analysis("fast", flops=0.0, hbm_bytes=0.0, bound_s=10.0)
        t.observe("fast", 1e-3)
        (row,) = t.snapshot()
        assert row["roofline_utilization"] == 1.0

    def test_snapshot_sorts_by_total_and_top_k(self):
        t = ExecTimer()
        t.observe("minor", 0.001)
        for _ in range(5):
            t.observe("major", 0.1)
        assert [r["executable"] for r in t.snapshot()] == ["major", "minor"]
        assert [r["executable"] for r in t.snapshot(top_k=1)] == ["major"]
        rep = t.report(top_k=1)
        assert rep["executables"] == 2 and len(rep["top"]) == 1

    def test_publish_emits_labelled_gauges(self):
        reg = MetricsRegistry()
        t = ExecTimer(reg)
        t.attach_analysis("step", flops=1e9, hbm_bytes=1e6)
        t.observe("step", 0.01)
        t.publish()
        lbl = {"executable": "step"}
        assert reg.value("exec_wall_seconds_total", lbl) == pytest.approx(0.01)
        assert reg.value("exec_calls_total", lbl) == 1.0
        assert 0.0 < reg.value("exec_roofline_utilization", lbl) <= 1.0
        assert reg.value("exec_analytic_disagreement", lbl) > 1.0

    def test_cache_hit_miss_counters(self):
        t = ExecTimer()
        t.cache_miss("embed_b32")
        t.cache_hit("embed_b32")
        t.cache_hit("embed_b32")
        assert t.registry.value("exec_cache_hits_total", {"executable": "embed_b32"}) == 2.0
        assert t.registry.value("exec_cache_misses_total", {"executable": "embed_b32"}) == 1.0

    def test_disabled_timer_is_inert(self):
        t = ExecTimer(enabled=False)
        t.observe("x", 1.0)
        t.cache_hit("x")
        t.attach_analysis("x", flops=1.0, hbm_bytes=1.0)
        assert t.snapshot() == [] and t.analyzed == 0
        assert t.metrics()["perf_observed_total"] == 0.0


# ---------------------------------------------------------------------------
# DecorrHealthMonitor
# ---------------------------------------------------------------------------


class TestDecorrHealthMonitor:
    def test_healthy_stream_reports_unit_variance(self):
        mon = _monitor()
        rng = np.random.default_rng(0)
        m = mon.observe(rng.standard_normal((64, 16)).astype(np.float32))
        assert m["train_decorr_feat_var_ema"] > 0.5
        assert m["train_decorr_collapsed_frac"] == 0.0
        assert "train_decorr_relaxation_gap" in m
        assert m["train_decorr_updates"] == 1.0

    def test_collapse_indicators_and_histogram(self):
        reg = MetricsRegistry()
        mon = _monitor()
        m = mon.observe(np.ones((32, 16), np.float32), registry=reg)
        assert m["train_decorr_feat_var_ema"] < 1e-6
        assert m["train_decorr_collapsed_frac"] == 1.0
        assert m["train_decorr_feat_var_min_ema"] < 1e-6
        assert reg.get("train_feat_var").count == 16
        assert reg.value("train_decorr_feat_var_ema") == pytest.approx(m["train_decorr_feat_var_ema"], abs=1e-9)

    def test_update_embeds_with_params(self):
        mon = _monitor(embed_fn=lambda params, batch: batch * params)

        class State:
            params = 2.0

        rng = np.random.default_rng(1)
        m = mon.update(State(), torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)), step=5)
        assert m["train_decorr_step"] == 5.0 and mon.updates == 1
        with pytest.raises(ValueError, match="embed_fn"):
            _monitor().update(State(), np.ones((4, 4), np.float32))

    def test_variance_collapse_alert_fires_once_and_clears(self):
        obs = Obs(alerts=AlertManager(default_train_rules()))
        mon = _monitor()
        fired = []
        obs.alerts.sink = fired.append
        rule = next(r for r in default_train_rules() if r.name == "train_variance_collapse")
        collapsed = np.full((32, 16), 0.25, np.float32)
        for _ in range(rule.window + 1):
            mon.observe(collapsed, registry=obs.registry)
            obs.scrape()
        assert [e["type"] for e in fired] == ["fire"]
        assert fired[0]["alert"] == "train_variance_collapse"
        assert fired[0]["severity"] == "critical"
        assert obs.registry.value("obs_alerts_fired_total", {"rule": "train_variance_collapse"}) == 1.0
        rng = np.random.default_rng(2)
        mon.observe(rng.standard_normal((32, 16)).astype(np.float32), registry=obs.registry)
        obs.scrape()
        assert [e["type"] for e in fired] == ["fire", "clear"]
        assert obs.alerts.active() == []
        assert obs.registry.value("obs_alerts_fired_total", {"rule": "train_variance_collapse"}) == 1.0


def test_health_gauges_equal_the_references_probe():
    """The monitor's gauges on one batch against the reference monitor's
    (the same numpy rows; self-correlation, no permutation needed for the
    moment gauges and R_off): the exact and relaxed terms and the gap."""
    rng = np.random.default_rng(4)
    z = (rng.standard_normal((48, 16)) + 0.4 * rng.standard_normal((48, 1))).astype(np.float32)
    got = _monitor().observe(z)
    want = ref_obs.DecorrHealthMonitor(ema=0.0).observe(z)
    for k in ("train_decorr_r_off", "train_decorr_r_off_norm", "train_decorr_feat_var_ema",
              "train_decorr_feat_mean_abs_ema", "train_decorr_collapsed_frac", "train_decorr_feat_var_min_ema",
              "train_decorr_n_eff", "train_decorr_updates"):
        assert got[k] == pytest.approx(want[k], rel=5e-4, abs=1e-7), k
    assert set(want) <= set(got) | {"train_decorr_mean_abs", "train_decorr_std_err"}


# ---------------------------------------------------------------------------
# Train-loop registry integration (duck-typed state)
# ---------------------------------------------------------------------------


def test_train_loop_publishes_registry():
    from repro_torch.train.loop import LoopConfig, run_training

    class State:
        step = 0

    def train_step(state, batch):
        state.step += 1
        return state, {"loss": 0.25}

    reg = MetricsRegistry()
    run_training(State(), train_step, lambda step: None, LoopConfig(total_steps=7, log_interval=2), registry=reg)
    assert reg.value("train_steps_total") == 7.0
    assert reg.get("train_step_seconds").count == 7
    assert reg.value("train_loss") == 0.25
    assert reg.value("train_stragglers") == 0.0
    assert reg.value("train_step_seconds_median") > 0.0


def test_train_loop_phase_timing_perf_and_monitor():
    from repro_torch.train.loop import LoopConfig, run_training

    class State:
        step = 0

    def train_step(state, batch):
        state.step += 1
        return state, {"loss": 0.5}

    rng = np.random.default_rng(0)

    def batch_fn(step):
        return rng.standard_normal((16, 8)).astype(np.float32)

    reg = MetricsRegistry()
    perf = ExecTimer(reg)
    monitor = _monitor(embed_fn=lambda params, batch: batch)
    run_training(State(), train_step, batch_fn, LoopConfig(total_steps=6, log_interval=2),
                 registry=reg, monitor=monitor, perf=perf)
    assert reg.get("train_batch_seconds").count == 6
    assert reg.get("train_publish_seconds").count == 3
    (row,) = [r for r in perf.snapshot() if r["executable"] == "train_step"]
    assert row["calls"] == 6 and row["total_s"] > 0
    assert monitor.updates == 3
    assert reg.value("train_decorr_updates") == 3.0
    assert reg.value("train_decorr_step") == 6.0
    assert reg.value("train_decorr_feat_var_ema") > 0.5
    assert reg.get("train_feat_var").count == 8 * 3


# ---------------------------------------------------------------------------
# Serve integration: one workload, four consistent telemetry views
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gemma():
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config("gemma2-2b").reduced()
    return cfg, init_params(cfg, seed=0, device="cpu")


class TestLMServiceObs:
    def _service(self, gemma, obs, **kw):
        from repro_torch.serve.engine import ContinuousLMEngine
        from repro_torch.serve.service import LMService

        cfg, params = gemma
        eng = ContinuousLMEngine(cfg, params, n_slots=4, max_len=64, max_prompt_len=24, paged=True, page_size=16,
                                 device="cpu", **kw)
        return LMService(eng, obs=obs)

    def _run(self, svc, cfg, n=6, new_tokens=4, seed=0):
        rng = np.random.default_rng(seed)
        futs = [svc.submit(rng.integers(0, cfg.vocab_size, 8).astype(np.int32), new_tokens) for _ in range(n)]
        svc.drain()
        for f in futs:
            f.result(timeout=60)
        return futs

    def test_legacy_dict_equals_registry_view(self, gemma):
        obs = Obs()
        svc = self._service(gemma, obs)
        self._run(svc, gemma[0])
        m = svc.metrics()
        for k in ("queue_depth", "dispatch_errors", "tokens_total", "tok_per_s", "ttft_p50_ms", "ttft_p99_ms",
                  "slots_total", "slots_occupancy", "slots_admitted_total", "slots_retired_total",
                  "latency_p50_ms", "latency_p99_ms", "served_total", "throughput_rps", "heartbeat_stale",
                  "admission_deferred", "paged_pages_in_use", "paged_pages_utilization"):
            assert k in m, f"key {k} missing from metrics()"
        for k, v in m.items():
            if k.startswith("heartbeat_age_s_"):
                continue
            assert obs.registry.value(k) == pytest.approx(v), k
        assert obs.registry.value("heartbeat_age_s_serve_lm_decode") is None
        for name in svc.heartbeat._last:
            assert obs.registry.value("heartbeat_age_s", {"name": name}) is not None

    def test_scrape_and_trace_tell_one_story(self, gemma, tmp_path):
        obs = Obs(alerts=AlertManager(default_serve_rules()))
        svc = self._service(gemma, obs)
        futs = self._run(svc, gemma[0])
        text = svc.scrape()
        assert "# TYPE tok_per_s gauge" in text
        assert 'heartbeat_age_s{name="serve.lm_decode"}' in text
        assert "serve_decode_step_seconds_bucket" in text
        trace = json.loads(open(obs.tracer.write(str(tmp_path / "trace.json"))).read())
        rec = reconstruct_request(trace, futs[0].trace.rid)
        assert rec["phases"] == ["queue", "prefill", "decode"]
        assert rec["ticks"] >= 1 and rec["retired"]
        ttfts = sorted(f.trace.ttft_s for f in futs)
        m = svc.metrics()
        assert m["ttft_p50_ms"] == pytest.approx(float(np.percentile(np.asarray(ttfts), 50) * 1e3), rel=1e-6)
        counts = obs.recorder.counts()
        assert counts["admit"] == len(futs) and counts["retire"] == len(futs)
        assert counts["page_alloc"] >= 1 and counts["page_free"] >= 1

    def test_probe_drift_alert_fires_once_and_clears(self, gemma):
        obs = Obs(alerts=AlertManager(default_serve_rules()))
        svc = self._service(gemma, obs)
        self._run(svc, gemma[0])
        fired = []
        obs.alerts.sink = fired.append
        base = svc.metrics()
        drifted = dict(base, decorr_r_sum_norm_ema=0.9)
        for _ in range(4):
            obs.check_alerts(drifted)
        assert [e["type"] for e in fired] == ["fire"]
        assert fired[0]["alert"] == "probe_r_sum_drift"
        obs.check_alerts(dict(base, decorr_r_sum_norm_ema=0.0))
        assert [e["type"] for e in fired] == ["fire", "clear"]
        assert obs.alerts.active() == []

    def test_perf_attribution_joins_serve_executables(self, gemma):
        obs = Obs()
        svc = self._service(gemma, obs)
        assert svc.engine.perf is obs.perf
        svc.warmup()
        self._run(svc, gemma[0])
        rows = {r["executable"]: r for r in obs.perf.snapshot()}
        for name in ("decode_step", "prefill_b8"):
            assert rows[name]["calls"] >= 1, name
            assert rows[name]["total_s"] > 0, name
        # warmup's first calls were timed, and the 8-token prompts all hit
        # the warmed prefill bucket
        assert rows["prefill_b8"]["compile_s"] > 0 and rows["decode_step"]["compile_s"] > 0
        assert obs.registry.value("exec_cache_hits_total", {"executable": "prefill_b8"}) >= 1.0
        svc.scrape()
        assert obs.registry.value("exec_calls_total", {"executable": "decode_step"}) == float(
            rows["decode_step"]["calls"])

    def test_disabled_obs_serves_identically(self, gemma):
        on = self._run(self._service(gemma, Obs()), gemma[0], seed=3)
        obs = Obs.disabled()
        svc = self._service(gemma, obs)
        assert svc.engine.perf is None
        off = self._run(svc, gemma[0], seed=3)
        for a, b in zip(on, off):
            assert np.array_equal(a.result(timeout=5), b.result(timeout=5))
        assert len(obs.tracer) == 0 and len(obs.recorder) == 0
        m = svc.metrics()
        assert "tok_per_s" in m and m["obs_enabled"] == 0.0


class TestEmbeddingServiceObs:
    def test_metrics_registry_and_trace(self):
        from repro_torch.serve.engine import ServeEngine
        from repro_torch.serve.service import EmbeddingService
        from repro_torch.train.ssl import SSLModelConfig, init_ssl_model

        model = SSLModelConfig(input_dim=8, backbone_widths=(16,), projector_widths=(16, 16))
        obs = Obs()
        svc = EmbeddingService(ServeEngine(model, init_ssl_model(model, seed=0), device="cpu"), obs=obs)
        futs = [svc.submit(np.ones(8, np.float32)) for _ in range(3)]
        while svc.run_pending():
            pass
        for f in futs:
            f.result(timeout=10)
        m = svc.metrics()
        for k in ("queue_depth", "compiled_buckets", "latency_p50_ms", "served_total", "heartbeat_stale"):
            assert k in m and obs.registry.value(k) == pytest.approx(m[k]), k
        rec = reconstruct_request(obs.tracer.to_chrome(), futs[0].trace.rid)
        assert rec["phases"] == ["queue", "dispatch"] and rec["retired"]
        assert obs.recorder.counts()["dispatch"] >= 1
        (row,) = [r for r in obs.perf.snapshot() if r["executable"].startswith("embed_b")]
        assert row["calls"] == 1


# ---------------------------------------------------------------------------
# The CLIs' telemetry flags
# ---------------------------------------------------------------------------


def test_serve_cli_obs_flags_write_every_output(tmp_path, capsys):
    from repro_torch.serve import cli

    out = {k: str(tmp_path / n) for k, n in (("trace", "trace.json"), ("metrics", "metrics.txt"),
                                             ("flight", "flight.json"), ("prof", "prof"))}
    argv = ["--smoke", "--device", "cpu", "--requests", "64", "--metrics-port", "0", "--trace-out", out["trace"],
            "--metrics-out", out["metrics"], "--flight-out", out["flight"], "--profile-dir", out["prof"]]
    assert cli.main(argv) == 0
    text = capsys.readouterr().out
    assert "every metric scraped" in text and "MISSING" not in text
    assert json.loads(open(out["trace"]).read())["traceEvents"]
    assert "# TYPE served_total gauge" in open(out["metrics"]).read()
    assert any(e["kind"] == "dispatch" for e in json.loads(open(out["flight"]).read())["events"])
    assert (tmp_path / "prof" / "trace_0.json").exists()


def test_train_launcher_obs_flags_scrape(capsys):
    from repro_torch.launch import train as launch

    launch.train(launch.parse_args(["--arch", "gemma2-2b", "--reduced", "--steps", "2", "--batch", "2", "--seq", "8",
                                    "--device", "cpu", "--metrics-port", "0", "--alerts"]))
    text = capsys.readouterr().out
    assert "[obs] scraped" in text and "train_step: 2 calls" in text


# ---------------------------------------------------------------------------
# The roofline join: attach_compiled / attach_jit, the warmups' attachments,
# attach_train_step
# ---------------------------------------------------------------------------


class TestExecTimerJoin:
    def test_attach_jit_analyses_a_real_call(self):
        """Twin of the reference's ``test_attach_jit_parses_real_hlo``: the
        op-level analysis of a product, joined; idempotent.  The analysis is
        not the first call, so no compile gauge is set."""
        x = torch.ones((32, 32))
        t = ExecTimer()
        assert t.attach_jit("matmul", lambda a, b: a @ b, x, x)
        t.observe("matmul", 1e-3)
        (row,) = t.snapshot()
        assert row["flops"] == 2.0 * 32**3 and row["bound_s"] > 0
        assert 0.0 < row["roofline_utilization"] <= 1.0
        assert "compile_s" not in row
        # idempotent: re-attaching the same name is a no-op that reports True
        assert t.attach_jit("matmul", lambda a, b: a @ b, x, x)
        assert t.analyzed == 1

    def test_attach_compiled_tolerates_bad_backends(self):
        class NoAnalysis:
            pass

        t = ExecTimer()
        assert t.attach_compiled("weird", NoAnalysis()) is False
        assert t.attach_jit("raises", lambda: 1 / 0) is False
        assert t.analyzed == 0

    def test_attach_compiled_joins_flops_bytes_and_collectives(self):
        from repro_torch.launch import hlo_cost

        a = hlo_cost.OpAnalysis(flops=67e12, hbm_bytes=1e6, collective_bytes={"all-reduce": 900e9},
                                flops_by_op={}, trip_counts={}, n_ops=1, flops_by_dtype={"float32": 67e12})
        t = ExecTimer()
        assert t.attach_compiled("step", a, compile_s=0.25)
        t.observe("step", 4.0)
        (row,) = t.snapshot()
        assert row["bound_s"] == pytest.approx(2.0) and row["dominant"] == "collective"
        assert row["disagreement"] == pytest.approx(2.0) and row["compile_s"] == 0.25
        # the default bound of attach_analysis counts collectives too
        t.attach_analysis("x", flops=0.0, hbm_bytes=0.0, collective_bytes=450e9)
        t.observe("x", 2.0)
        assert {r["executable"]: r["bound_s"] for r in t.snapshot()}["x"] == pytest.approx(1.0)


def _lm_engines(opts):
    """(port engine, reference engine) of reduced gemma2-2b with ``opts``."""
    import jax

    from repro.configs import get_config as ref_config
    from repro.models import init_params as ref_init
    from repro.serve import ContinuousLMEngine as RefEngine
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ContinuousLMEngine

    cfg, rcfg = get_config("gemma2-2b").reduced(), ref_config("gemma2-2b").reduced()
    kw = dict(n_slots=4, max_len=48, max_prompt_len=24, **opts)
    port = ContinuousLMEngine(cfg, init_params(cfg, device="cpu"), device="cpu", **kw)
    ref = RefEngine(rcfg, ref_init(jax.random.PRNGKey(0), rcfg), **kw)
    return port, ref


@pytest.mark.parametrize(
    "opts",
    [{}, dict(paged=True, page_size=8), dict(paged=True, page_size=8, speculative=True, draft_k=2),
     dict(paged=True, page_size=8, prefill_chunk=8)],
    ids=["dense", "paged", "speculative", "chunked"],
)
def test_lm_engine_warmup_attaches_the_reference_names(opts):
    port, ref = _lm_engines(opts)
    port.perf, ref.perf = ExecTimer(), ref_obs.ExecTimer()
    assert port.warmup() == ref.warmup()
    names = set(port.perf._analysis)
    assert names == set(ref.perf._analysis)
    assert port.perf.analyzed == len(names) >= 2
    assert {"decode_step", "verify_step", "chunk_prefill"} & names == (
        {"decode_step"} | ({"verify_step"} if opts.get("speculative") else set())
        | ({"chunk_prefill"} if opts.get("prefill_chunk") else set()))


def test_embedding_engine_and_probe_attach_the_reference_names():
    import jax

    from repro.serve import buckets as rbuckets
    from repro.serve.engine import ServeEngine as RefServeEngine
    from repro.serve.probes import DecorrProbe as RefProbe
    from repro.train.ssl import SSLModelConfig as RefModelConfig
    from repro.train.ssl import init_ssl_params
    from repro_torch.serve import buckets
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.probes import DecorrProbe
    from repro_torch.train.ssl import SSLModelConfig, init_ssl_model

    widths = dict(input_dim=12, backbone_widths=(16,), projector_widths=(24, 32))
    port = ServeEngine(SSLModelConfig(**widths), init_ssl_model(SSLModelConfig(**widths), device="cpu"),
                       policy=buckets.BucketPolicy(max_batch=16), device="cpu")
    ref = RefServeEngine(RefModelConfig(**widths), init_ssl_params(jax.random.PRNGKey(0), RefModelConfig(**widths)),
                         policy=rbuckets.BucketPolicy(max_batch=16))
    probe, rprobe = DecorrProbe(device="cpu"), RefProbe()
    for obj, t in ((port, ExecTimer()), (probe, None), (ref, ref_obs.ExecTimer()), (rprobe, None)):
        obj.perf = t
    probe.perf, rprobe.perf = port.perf, ref.perf
    port.warmup(), ref.warmup()
    probe.warmup(32), rprobe.warmup(32)
    assert set(port.perf._analysis) == set(ref.perf._analysis)
    assert "probe_update" in port.perf._analysis and any(n.startswith("embed_b") for n in port.perf._analysis)


def test_attachment_leaves_pool_and_tokens_unchanged():
    """A timed service (every executable attached at warmup) and an untimed
    one emit the same tokens; after warmup their pools are byte-identical."""
    from repro_torch.serve.service import LMService

    opts = dict(paged=True, page_size=8, speculative=True, draft_k=2, prefill_chunk=8)
    timed, _ = _lm_engines(opts)
    plain, _ = _lm_engines(opts)
    timed.perf = ExecTimer()
    svc_t, svc_p = LMService(timed).warmup(), LMService(plain).warmup()
    assert timed.perf.analyzed == len(timed.prompt_bucket_sizes()) + 3
    for name, leaves in timed.caches.items():
        for k, v in leaves.items():
            assert torch.equal(v, plain.caches[name][k]), (name, k)
    rng = np.random.default_rng(3)
    prompts = [(rng.integers(0, 256, n).astype(np.int32), m) for n, m in ((5, 6), (12, 4), (20, 7), (3, 5))]
    outs = []
    for svc in (svc_t, svc_p):
        futs = [svc.submit(t, m) for t, m in prompts]
        svc.drain()
        outs.append([np.asarray(f.result(timeout=60)) for f in futs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_train_cli_with_telemetry_attaches_the_train_step(capsys):
    from repro_torch.train import cli

    assert cli.main(["--tiny", "--device", "cpu", "--steps", "4", "--metrics-port", "0", "--pretune", "off"]) == 0
    out = capsys.readouterr().out
    assert "[obs] scraped" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("[obs]   train_step:"))
    assert "4 calls" in line and "util=" in line  # measured and joined


def test_attach_train_step_joins_the_lm_step():
    import argparse

    from repro_torch.configs import get_config
    from repro_torch.launch.obs_args import attach_train_step, build_train_obs
    from repro_torch.models import ParamTree, init_params
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import create_train_state, make_train_step

    cfg = get_config("gemma2-2b").reduced()
    opt = adamw()
    state = create_train_state(ParamTree(init_params(cfg, device="cpu")), opt)
    step = make_train_step(cfg, opt, warmup_cosine(1e-3, 1, 10))
    toks = torch.zeros((2, 16), dtype=torch.int32)
    before = [p.detach().clone() for p in state.model.parameters()]
    obs = build_train_obs(argparse.Namespace(metrics_port=None, alerts=True))
    assert attach_train_step(obs, step, state, {"tokens": toks, "labels": toks})
    assert obs.perf.analyzed == 1 and state.step == 0
    assert all(torch.equal(a, p.detach()) for a, p in zip(before, state.model.parameters()))
    assert attach_train_step(None, step, state, {}) is False
