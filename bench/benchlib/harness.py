"""One run of one cell: set-up, the timed window, the traced extras, the
correctness check and the result.

The order of a run:

1. the cell's driver builds the system's training step with its model and
   optimizer state from the seed, drives it through its first steps (the
   steps the reference follows) and warms every shape the window uses;
   ``setup_s`` runs from the process's start to here;
2. the window calls the driver's ``step`` until ``seconds`` have passed on
   the host clock, then waits for the device: a rate is all the work over
   all of that time.  With ``trace`` each call's host time is kept (no
   device wait);
3. with ``trace``, short stretches of further calls under the profiler
   (``trace.profile``; the system's kernel launches a call over them), and
   the driver's own probes, all outside the window's timing;
4. the device's peak memory is read, the system's state is freed, and the
   driver's plain reference follows the same first steps; the comparison
   (``compare``) decides ``correct``;
5. every metric of the cell is read from the run's record by its reader.
"""

from __future__ import annotations

import gc
import math
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

from bench.benchlib import compare, spec as spec_lib, trace as trace_lib

ROOT = Path(__file__).resolve().parents[2]


def _device_info(torch, dev, peak: int) -> Dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1, "memory_peak_bytes": peak}


def _launches() -> Dict[str, int]:
    """The system's own count of its hand-written kernels' launches, by kernel."""
    from repro_torch import kernels

    return kernels.launch_counts()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT, device: str = "cuda",
             t_start: Optional[float] = None) -> Dict:
    """Run cell ``workload`` once and return its result (the JSON line's
    object, ``checks`` last).  ``t_start``: the host clock's reading at the
    process's start (``time.perf_counter()``); ``device`` other than
    ``"cuda"`` is for the tests' small runs."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    c = spec_lib.cell(root, workload)
    drv = spec_lib.driver(c)
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t_setup = time.perf_counter()
    sess = drv.setup(c, seed, dev)
    sync()
    # set-up's objects (the model, its state, the batch pool, the imported
    # modules) live as long as the run: the collector no longer scans them,
    # as a long training job's collector rarely does once they are old; the
    # objects each step makes are collected as they would be in any loop
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    phases = {"start_to_driver_s": t_setup - t_start, **sess.phases}

    spans = []
    steps = 0
    t0 = time.perf_counter()
    while True:
        if trace:
            a = time.perf_counter()
            sess.step()
            spans.append(time.perf_counter() - a)
        else:
            sess.step()
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    failed = sess.failed()

    record: Dict = {
        "cell": c.name, "driver": c.traffic["driver"], "config": c.config, "traffic": c.traffic,
        "setup_s": setup_s, "window_s": window_s, "steps": steps, "work": sess.work, "counts": sess.counts,
        "spans": {"dispatch_s": spans} if trace else {},
    }
    breakdown = None
    if trace:
        calls = int(c.traffic.get("trace_calls", 10))
        before = _launches()
        with tempfile.TemporaryDirectory() as tmp:
            record["profile"] = trace_lib.profile(calls, sess.step, sync, tmp)
        after = _launches()
        made = record["profile"]["calls"]
        record["kernel_launches"] = {k: (n - before.get(k, 0)) / made for k, n in sorted(after.items())
                                     if n != before.get(k, 0)}
        record.update(sess.probe(sync))
        breakdown = {k: record["profile"][k] for k in ("device_ops", "idle_gaps")}
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    record["peak_bytes"] = peak
    program = sess.readings
    sess.close()
    del sess
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    reference = drv.reference(c, seed, dev)
    reference_s = time.perf_counter() - t_ref
    checks = compare.judge(compare.numbers(program, reference), c.limits)
    correct = failed == 0 and compare.passed(checks)

    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        value = spec_lib.reader(c, m["name"])(record)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing in cell {c.name}")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    info = _device_info(torch, dev, peak)
    if trace:
        info["busy_s"] = record["profile"]["busy_s"]
        info["window_s"] = record["profile"]["window_s"]
    result = {"correct": bool(correct), "attempted": steps, "failed": failed, "metrics": metrics, "device": info,
              "setup_phases": phases, "window_s": window_s, "reference_s": reference_s}
    if breakdown is not None:
        result["breakdown"] = breakdown
        result["kernel_launches"] = record["kernel_launches"]
        # a call's wall time in the traced stretch beside the window's: the
        # profiler's own cost shows as their difference
        result["call_s"] = {"window": window_s / steps, "traced": record["profile"]["window_s"] / calls}
    result["checks"] = {k: {"value": v["value"] if math.isfinite(v["value"]) else str(v["value"]),
                            "limit": v["limit"]} for k, v in checks.items()}
    return result
