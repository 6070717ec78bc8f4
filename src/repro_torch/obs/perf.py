"""Per-executable device-time attribution with a roofline join (port of
``repro/obs/perf.py``).

The serve and train stacks run a handful of distinct device programs (the
per-bucket embedding forwards, per-bucket prefills, the batched decode
tick, the chunked-prefill step, the probe update, the train step), and the
aggregate (tok/s) hides a regression in any one of them.  ``ExecTimer`` is
the attribution layer:

  * **wall time** — a labelled ``exec_seconds{executable=...}`` histogram
    plus host-side calls / total / best stats per executable (the ``/perf``
    endpoint reads these).  An engine with a timer attached waits for the
    call's device work before it reads the clock (``ExecTimer.block``: a
    CUDA event recorded after the call and synchronised), so the time
    covers the device's work; an engine without one (``perf = None``)
    stays asynchronous;
  * **first-call time** — ``exec_compile_seconds{executable=...}`` gauges,
    set where an engine's warmup runs a shape for the first time (in eager
    PyTorch the first call builds the CUDA kernels and caches the
    allocator's blocks; there is no separate compile);
  * **shape-cache traffic** — ``exec_cache_{hits,misses}_total`` counters
    from the engines' bucket ladders;
  * **the roofline join** — ``attach_compiled`` / ``attach_jit`` take an
    executable's op-level analysis (``repro_torch.launch.hlo_cost``: FLOPs
    by dtype, bytes, collectives and kernel launches of one call, recorded
    on fake copies of its arguments — the same analyzer the tune dry tier
    uses) and every snapshot derives achieved GFLOP/s and GB/s, a
    roofline-utilization gauge ``min(1, bound_s / best_measured_s)`` and
    the disagreement ratio ``best_measured_s / bound_s``.  The bound is
    ``hlo_cost.roofline_terms``' H100 SXM roofline.

Everything is lazy and failure-tolerant: the analyzer is imported only when
something attaches, an executable the analyzer cannot run simply yields no
join, and a disabled timer (``Obs.disabled()``) costs one attribute read per hot-path
check, because the engines hold ``perf = None`` instead of a disabled object.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.obs.registry import DEFAULT_BUCKETS, MetricsRegistry

# executable steps on a warm pool run well under the latency ladder's 100us
# floor on a GPU — extend the default buckets downward
EXEC_BUCKETS = (1e-5, 2.5e-5, 5e-5) + DEFAULT_BUCKETS


class _ExecStat:
    __slots__ = ("calls", "total_s", "best_s")

    def __init__(self):
        self.calls = 0
        self.total_s = 0.0
        self.best_s = math.inf


class ExecTimer:
    """Labelled wall-time attribution + analytic-cost join per executable."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        *,
        enabled: bool = True,
        clock=time.perf_counter,
    ):
        self.enabled = bool(enabled)
        self.registry = registry if registry is not None else MetricsRegistry()
        self._clock = clock
        self._lock = threading.Lock()
        self._stats: Dict[str, _ExecStat] = {}
        self._analysis: Dict[str, Dict[str, Any]] = {}
        self._compile_s: Dict[str, float] = {}
        self.observed_total = 0
        r = self.registry
        self._h_exec = r.histogram(
            "exec_seconds", "per-executable wall time",
            labelnames=("executable",), buckets=EXEC_BUCKETS,
        )
        self._g_compile = r.gauge(
            "exec_compile_seconds", "first-call (warmup) wall time",
            labelnames=("executable",),
        )
        self._c_hits = r.counter(
            "exec_cache_hits_total", "shape-cache hits",
            labelnames=("executable",),
        )
        self._c_misses = r.counter(
            "exec_cache_misses_total", "shape-cache misses",
            labelnames=("executable",),
        )

    # -- hot path -------------------------------------------------------------
    # engines guard every call with `if self.perf is not None`, so a disabled
    # bundle never reaches these; the methods themselves still honor
    # `enabled` so a shared timer can be switched off without re-wiring.

    def start(self) -> float:
        return self._clock()

    def elapsed(self, t0: float) -> float:
        return self._clock() - t0

    @staticmethod
    def block(x) -> None:
        """Wait for the device work issued so far on ``x``'s device (a
        tensor, a ``torch.device`` or None): a CUDA event recorded on the
        current stream and synchronised; nothing on the CPU, whose work is
        done when the call returns."""
        device = x.device if isinstance(x, torch.Tensor) else x
        if device is not None and torch.device(device).type == "cuda":
            with torch.cuda.device(device):
                ev = torch.cuda.Event()
                ev.record()
                ev.synchronize()

    def observe(self, name: str, seconds: float):
        """Fold one executable invocation's wall time into the stream."""
        if not self.enabled:
            return
        s = float(seconds)
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                st = self._stats[name] = _ExecStat()
            st.calls += 1
            st.total_s += s
            if s < st.best_s:
                st.best_s = s
            self.observed_total += 1
        self._h_exec.labels(executable=name).observe(s)

    def cache_hit(self, name: str):
        if self.enabled:
            self._c_hits.labels(executable=name).inc()

    def cache_miss(self, name: str):
        if self.enabled:
            self._c_misses.labels(executable=name).inc()

    # -- the analytic join ----------------------------------------------------

    def record_compile(self, name: str, seconds: float):
        if not self.enabled:
            return
        with self._lock:
            self._compile_s[name] = float(seconds)
        self._g_compile.labels(executable=name).set(float(seconds))

    def attach_analysis(
        self,
        name: str,
        *,
        flops: float,
        hbm_bytes: float,
        collective_bytes: float = 0.0,
        bound_s: Optional[float] = None,
        dominant: Optional[str] = None,
        compile_s: Optional[float] = None,
    ):
        """Attach analytic costs directly (tests; callers with their own
        cost model).  ``bound_s`` defaults to the hlo_cost roofline bound
        (FLOPs priced at the f32 peak)."""
        if not self.enabled:
            return
        if bound_s is None:
            from repro_torch.launch.hlo_cost import OpAnalysis, roofline_terms

            terms = roofline_terms(OpAnalysis(
                flops=flops, hbm_bytes=hbm_bytes, collective_bytes={"all-reduce": collective_bytes},
                flops_by_op={}, trip_counts={}, n_ops=0,
            ))
            dominant = dominant or terms["dominant"]
            bound_s = terms["bound_s"]
        with self._lock:
            self._analysis[name] = {
                "flops": float(flops),
                "hbm_bytes": float(hbm_bytes),
                "collective_bytes": float(collective_bytes),
                "bound_s": float(bound_s),
                "dominant": dominant,
            }
        if compile_s is not None:
            self.record_compile(name, compile_s)

    def attach_compiled(self, name: str, analysis, compile_s: Optional[float] = None) -> bool:
        """Join one executable's ``hlo_cost.OpAnalysis``: its FLOPs, bytes
        and collectives and their roofline terms.  Idempotent per name;
        returns False (and attaches nothing) when ``analysis`` is not an
        analysis the roofline can price."""
        if not self.enabled:
            return False
        with self._lock:
            if name in self._analysis:
                return True
        try:
            from repro_torch.launch.hlo_cost import roofline_terms

            terms = roofline_terms(analysis)
            flops, hbm = float(analysis.flops), float(analysis.hbm_bytes)
            coll = float(analysis.total_collective_bytes)
        except Exception:
            return False
        self.attach_analysis(
            name,
            flops=flops,
            hbm_bytes=hbm,
            collective_bytes=coll,
            bound_s=terms["bound_s"],
            dominant=terms["dominant"],
            compile_s=compile_s,
        )
        return True

    def attach_jit(self, name: str, fn, *args, **kw) -> bool:
        """Analyse ``fn(*args, **kw)`` on fake copies of its arguments
        (``hlo_cost.analyze``: nothing runs on the device, no argument
        changes) and join the result.  The first-call gauge is left as it
        is: in eager PyTorch the engines time an executable's first real
        call as its compile time (``record_compile``), and an analysis is
        not that call.  Idempotent per name; False when the analysis
        raises."""
        if not self.enabled:
            return False
        with self._lock:
            if name in self._analysis:
                return True
        try:
            from repro_torch.launch.hlo_cost import analyze

            analysis = analyze(fn, *args, **kw)
        except Exception:
            return False
        return self.attach_compiled(name, analysis)

    @property
    def analyzed(self) -> int:
        with self._lock:
            return len(self._analysis)

    # -- read side ------------------------------------------------------------

    def snapshot(self, top_k: Optional[int] = None) -> List[Dict[str, Any]]:
        """Per-executable rows, slowest total first: measured stats joined
        with the analytic roofline (achieved GFLOP/s and GB/s from the BEST
        measured time — the least-noisy invocation; utilization clamped into
        (0, 1]; ``disagreement`` = measured/analytic, >= 1 by construction,
        the validate-against-wall-time ratio)."""
        with self._lock:
            stats = {n: (s.calls, s.total_s, s.best_s) for n, s in self._stats.items()}
            analysis = dict(self._analysis)
            compile_s = dict(self._compile_s)
        rows: List[Dict[str, Any]] = []
        for name, (calls, total_s, best_s) in stats.items():
            row: Dict[str, Any] = {
                "executable": name,
                "calls": calls,
                "total_s": total_s,
                "best_s": best_s,
                "mean_s": total_s / max(calls, 1),
            }
            if name in compile_s:
                row["compile_s"] = compile_s[name]
            a = analysis.get(name)
            if a is not None:
                best = max(best_s, 1e-9)
                bound = a["bound_s"]
                row.update(
                    flops=a["flops"],
                    hbm_bytes=a["hbm_bytes"],
                    bound_s=bound,
                    dominant=a["dominant"],
                    achieved_gflops=a["flops"] / best / 1e9,
                    achieved_gbps=a["hbm_bytes"] / best / 1e9,
                    roofline_utilization=min(1.0, bound / best) if bound > 0 else 0.0,
                    disagreement=(best / bound) if bound > 0 else None,
                )
            rows.append(row)
        rows.sort(key=lambda r: r["total_s"], reverse=True)
        return rows[:top_k] if top_k else rows

    def report(self, top_k: int = 10) -> Dict[str, Any]:
        """The ``/perf`` endpoint payload: top-k slowest executables with
        their utilization, plus the aggregate counts."""
        return {
            "executables": len(self._stats),
            "analyzed": self.analyzed,
            "observed_total": self.observed_total,
            "top": self.snapshot(top_k),
        }

    def publish(self, registry: Optional[MetricsRegistry] = None):
        """Mirror the derived roofline values as labelled gauges (scrape
        path: called by ``Obs.scrape`` each cycle, like quantile gauges)."""
        if not self.enabled:
            return
        r = registry if registry is not None else self.registry
        g_total = r.gauge("exec_wall_seconds_total", "summed executable wall time",
                          labelnames=("executable",))
        g_calls = r.gauge("exec_calls_total", "executable invocations",
                          labelnames=("executable",))
        g_util = r.gauge("exec_roofline_utilization",
                         "analytic roofline bound / best measured time, clamped to 1",
                         labelnames=("executable",))
        g_gflops = r.gauge("exec_achieved_gflops", "FLOPs / best measured second / 1e9",
                           labelnames=("executable",))
        g_gbps = r.gauge("exec_achieved_gbps", "HBM bytes / best measured second / 1e9",
                         labelnames=("executable",))
        g_dis = r.gauge("exec_analytic_disagreement",
                        "best measured time / analytic roofline bound",
                        labelnames=("executable",))
        for row in self.snapshot():
            lbl = {"executable": row["executable"]}
            g_total.labels(**lbl).set(row["total_s"])
            g_calls.labels(**lbl).set(float(row["calls"]))
            if "roofline_utilization" in row:
                g_util.labels(**lbl).set(row["roofline_utilization"])
                g_gflops.labels(**lbl).set(row["achieved_gflops"])
                g_gbps.labels(**lbl).set(row["achieved_gbps"])
                if row["disagreement"] is not None:
                    g_dis.labels(**lbl).set(row["disagreement"])

    def metrics(self, prefix: str = "perf_") -> Dict[str, float]:
        with self._lock:
            return {
                f"{prefix}executables": float(len(self._stats)),
                f"{prefix}analyzed": float(len(self._analysis)),
                f"{prefix}observed_total": float(self.observed_total),
            }
