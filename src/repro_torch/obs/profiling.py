"""Opt-in profiling hooks: ``torch.profiler`` trace capture behind a tiny
start / stop API (port of ``repro/obs/profiling.py``).

Profiling is the one telemetry layer that is NOT always on — a profiler
trace costs real overhead and disk, so capture is explicit: the service API
(``LMService.start_profiling``), the CLI (``--profile-dir``), or a direct
``Profiler`` call.  A start or stop that fails (a second profiler already
running, an export that cannot be written) logs a warning and returns
``False`` / ``None``: profiling must never take the serving path down.

The capture records CPU activity always and CUDA activity (CUPTI) when
CUDA is available; ``stop`` exports a Chrome
trace (``trace_<n>.json``, chrome://tracing or Perfetto) into the trace
directory and returns its path.

The cheap always-on counterpart — per-executable step-time histograms for
prefill / chunked prefill / decode — lives in the metrics registry
(``serve_*_seconds``), fed by the service tick; this module only owns the
heavyweight trace capture.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch

log = logging.getLogger("repro_torch.obs.profiling")


class Profiler:
    """Start / stop ``torch.profiler`` traces into a directory."""

    def __init__(self, trace_dir: Optional[str] = None):
        self.trace_dir = trace_dir
        self.active = False
        self.sessions = 0
        self.errors = 0
        self._prof = None

    def start(self, trace_dir: Optional[str] = None) -> bool:
        """Begin a capture; returns False (and stays inert) when profiling
        cannot start — no directory configured, already active, or the
        profiler refuses."""
        trace_dir = trace_dir or self.trace_dir
        if trace_dir is None or self.active:
            return False
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
        except Exception as e:
            self.errors += 1
            log.warning("torch.profiler trace did not start: %s", e)
            return False
        self._prof = prof
        self.trace_dir = trace_dir
        self.active = True
        return True

    def stop(self) -> Optional[str]:
        """End the capture and export it; returns the Chrome trace's path, or
        None if no capture was running or the export failed."""
        if not self.active:
            return None
        self.active = False
        prof, self._prof = self._prof, None
        try:
            prof.__exit__(None, None, None)
            os.makedirs(self.trace_dir, exist_ok=True)
            path = os.path.join(self.trace_dir, f"trace_{self.sessions}.json")
            prof.export_chrome_trace(path)
        except Exception as e:
            self.errors += 1
            log.warning("torch.profiler trace did not stop cleanly: %s", e)
            return None
        self.sessions += 1
        return path

    def metrics(self, prefix: str = "profiler_") -> Dict[str, float]:
        return {
            f"{prefix}active": 1.0 if self.active else 0.0,
            f"{prefix}sessions_total": float(self.sessions),
            f"{prefix}errors_total": float(self.errors),
        }
