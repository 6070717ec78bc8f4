"""The device trace of short stretches of timed calls, and what is read off it.

``profile(calls, fn, sync, tmpdir)`` runs ``fn`` ``calls`` times under
``torch.profiler`` twice, each time writing the Chrome trace to a file in
``tmpdir``, reading it back and removing it:

1. with the CUDA activity alone (CUPTI: the device's kernels, copies and
   sets, and the runtime calls that launch them; no record of the host's
   operators, whose recording would slow the host and widen the device's
   gaps).  From it:

   * ``busy_s``: the union of the device's kernel, copy and set intervals;
   * ``window_s``: the stretch's wall time on the host clock (synchronised
     before and after), ``stretch_calls`` its calls;
   * ``device_ops``: device time by operation name, the largest first;

2. with the CPU activity as well, only to name the gaps: ``idle_gaps``, the
   intervals in which the device ran nothing, each named by the host
   operation that was running then (the innermost CPU op that covers the
   gap's midpoint), summed by name, the largest first.  The host's
   recording widens these gaps, so their seconds say where the host was,
   not how long the device idles in a timed call; that is ``busy_s``
   against ``window_s``.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
MARK = "bench.window"
TOP = 10
RETAKES = 3


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _device(events: List[Dict]) -> List[Dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def _merged(dev: List[Dict]) -> List[Tuple[float, float]]:
    return _union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in dev])


def _label(host: List[Dict], mids: List[float]) -> List[str]:
    """For each time in ``mids`` (ascending), the name of the shortest host
    op running then, or "host (between ops)"."""
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", "?")) for e in host
                  if e.get("name") != MARK)
    out, active, i = [], [], 0
    for mid in mids:
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        out.append(min(active, key=lambda h: h[1] - h[0])[2] if active else "host (between ops)")
    return out


def device_time(events: List[Dict]) -> Dict:
    """Busy seconds and device time by operation from Chrome-trace events (times in us)."""
    dev = _device(events)
    by_op: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_op[e.get("name", "?")] += float(e.get("dur", 0)) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": sum(b - a for a, b in _merged(dev)) * 1e-6, "device_ops": [[k, v] for k, v in top],
            "device_events": len(dev)}


def idle_gaps(events: List[Dict], t0_us: float, t1_us: float) -> List[List]:
    """The gaps in [t0_us, t1_us] in which the device ran nothing, named by
    the host op running then and summed by name, the largest first."""
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    edges = [t0_us] + [x for ab in _merged(_device(events)) for x in ab] + [t1_us]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    by_gap: Dict[str, float] = defaultdict(float)
    for (a, b), name in zip(gaps, _label(host, [0.5 * (a + b) for a, b in gaps])):
        by_gap[name] += (b - a) * 1e-6
    return [[k, v] for k, v in sorted(by_gap.items(), key=lambda kv: -kv[1])[:TOP]]


def _traced(activities, calls: int, fn: Callable[[], None], sync: Callable[[], None], tmpdir: str):
    """The Chrome-trace events of ``calls`` calls of ``fn`` and their host wall time."""
    import torch

    sync()
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(MARK):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            sync()
            window_s = time.perf_counter() - t0
    path = os.path.join(tmpdir, f"bench_trace_{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        if os.path.exists(path):
            os.remove(path)
    return events, window_s


def profile(calls: int, fn: Callable[[], None], sync: Callable[[], None], tmpdir: str) -> Dict:
    """Trace ``calls`` calls of ``fn`` twice and reduce the traces (see the
    module note); ``calls`` in the result counts every call made."""
    import torch
    from torch.profiler import ProfilerActivity

    # nothing is pending on the device when the stretch starts (``sync``), so
    # every device event of this trace belongs to its calls; without a card
    # (the tests' small runs) the stretch records the host and finds no
    # device event
    cuda = torch.cuda.is_available()
    for made in range(1, RETAKES + 1):
        events, window_s = _traced([ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU], calls, fn, sync,
                                   tmpdir)
        out = {**device_time(events), "window_s": window_s, "stretch_calls": calls}
        # now and then a session records no device event at all: take it again
        if out["device_events"] or not cuda:
            break
    events, _ = _traced([ProfilerActivity.CPU, ProfilerActivity.CUDA], calls, fn, sync, tmpdir)
    mark = [e for e in events if e.get("name") == MARK and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if mark:
        t0_us = float(mark[0]["ts"])
        t1_us = t0_us + float(mark[0].get("dur", 0))
    else:
        ts = [float(e["ts"]) for e in events if e.get("ph") == "X"]
        t0_us, t1_us = min(ts), max(ts)
    inside = [e for e in events if e.get("ph") == "X" and t0_us <= float(e.get("ts", -1)) <= t1_us]
    out["idle_gaps"] = idle_gaps(inside, t0_us, t1_us)
    out["calls"] = (made + 1) * calls
    return out
