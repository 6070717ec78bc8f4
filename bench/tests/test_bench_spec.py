"""BENCHMARK.json and the data files beside the harness: every name the
benchmark uses resolves to its file, the entries keep to the benchmark's
format, and a cell and a metric are added by adding files alone."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from bench.benchlib import harness, spec

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_format():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"] == ["python3", "bench/run.py"] and BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check: 2 + 14 runs a cell, each run_seconds + 60 s, 180 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    metric_keys = {"name", "unit", "better", "source"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == metric_keys | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == metric_keys | {"layer", "moves"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in BENCH["workloads"]:
        mine = [m["name"] for m in BENCH["end_to_end"] if spec.applies(m, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(spec.applies(m, w["name"]) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            assert spec.applies(moved, cell), (m["name"], cell)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(workload):
    c = spec.cell(REPO, workload)
    assert (c.bench_dir / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert set(c.limits) == {"loss_rel", "grad_gap", "change_gap"}
    assert c.config["name"] == c.config_name and "reduced" in c.config and "assumed" in c.config
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(c, m["name"]))


def test_config_files_state_their_source_and_cuts():
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    """A throwaway traffic mix, cell, limits file and metric reader, added
    beside a copy of the benchmark: the harness runs the new cell and
    reports the new metric without an edit to any file already there."""
    from bench.tests.conftest import make_small_root

    root = make_small_root(tmp_path)
    bench_dir = root / "bench"
    traffic = json.loads((bench_dir / "traffic" / "bt_rsum_b128.json").read_text())
    traffic["pool"] = 5
    (bench_dir / "traffic" / "bt_rsum_pool5.json").write_text(json.dumps(traffic))
    (bench_dir / "limits" / "ssl_added_cell.json").write_text(
        (bench_dir / "limits" / "ssl_bt_rsum_b128_d8192.json").read_text())
    (bench_dir / "metrics" / "steps_in_window.py").write_text(
        '"""Timed steps in the window."""\n\n\ndef read(rec):\n    return rec["steps"]\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ssl_added_cell", "config": "ssl-paper-d8192",
                               "traffic": "bt_rsum_pool5", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "ssl_train_samples_per_s":
            m["workloads"].append("ssl_added_cell")
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "host step dispatch",
                               "moves": "ssl_train_samples_per_s", "workloads": ["ssl_added_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (REPO / "bench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    out = harness.run_cell("ssl_added_cell", 5, 0.05, True, root=root, device="cpu")
    assert out["correct"] and out["metrics"]["steps_in_window"]["value"] == out["attempted"]
    out = harness.run_cell("ssl_added_cell", 5, 0.05, False, root=root, device="cpu")
    assert set(out["metrics"]) == {"ssl_train_samples_per_s", "peak_mem_gib", "setup_s"}
    after = {p: p.read_bytes() for p in (REPO / "bench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    assert before == after


def test_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    proc = subprocess.run([sys.executable, str(REPO / "bench" / "run.py"), "--workload", "ssl_bt_rsum_b128_d8192",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_trace_reduction_reads_busy_time_and_names_the_gaps():
    from bench.benchlib import trace

    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [ev("kernel", "gemm", 0, 10), ev("kernel", "gemm", 5, 15), ev("gpu_memcpy", "copy", 30, 10),
              ev("cpu_op", "outer", 0, 50), ev("cpu_op", "aten::mm", 18, 17)]
    got = trace.device_time(events)
    assert got["busy_s"] == pytest.approx(30e-6) and got["device_events"] == 3
    assert got["device_ops"] == [["gemm", pytest.approx(25e-6)], ["copy", pytest.approx(10e-6)]]
    gaps = trace.idle_gaps(events, 0, 50)
    assert gaps == [["aten::mm", pytest.approx(10e-6)], ["outer", pytest.approx(10e-6)]]


def test_idle_share_holds_busy_time_a_call_against_the_windows_wall_time_a_call():
    from bench.benchlib import readers

    rec = {"steps": 10, "window_s": 1.0, "profile": {"busy_s": 0.18, "stretch_calls": 2, "window_s": 0.25}}
    assert readers.idle_share(rec) == pytest.approx(10.0)
    assert readers.idle_share({"steps": 10, "window_s": 1.0}) is None
