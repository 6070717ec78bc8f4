"""Readers shared by families of per-layer metrics.

A metric's own file under ``<bench>/metrics/`` names one of these as its
``read``; BENCHMARK.json's ``workloads`` key of the metric says in which
cells it is read.  Each returns None where the run's record holds nothing
to read (an untraced run).
"""

from __future__ import annotations

from typing import Dict, Optional

from bench.counts import decorr_loss


def dispatch_ms(rec: Dict) -> Optional[float]:
    """Host milliseconds a timed call takes to return, summed over the
    window's calls and divided by their number.  The harness adds no device
    wait; where the step itself waits for the device, this reads the step's
    time."""
    spans = rec["spans"].get("dispatch_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)


def idle_share(rec: Dict) -> Optional[float]:
    """Share of a timed call's wall time in which the device ran no kernel,
    copy or set, in %: the device's busy time a call, from the traced
    stretch (the profiler's CUDA activity alone), against the wall time a
    call took in the window, where no profiler ran.  The traced stretch's
    own wall time (the line's ``device.window_s``) carries the profiler's
    cost of recording each launch, which the device's busy time does not."""
    prof = rec.get("profile")
    if not prof or not rec["steps"] or prof["busy_s"] <= 0:
        return None
    busy_per_call = prof["busy_s"] / prof["stretch_calls"]
    return 100.0 * (1.0 - busy_per_call / (rec["window_s"] / rec["steps"]))


def loss_roofline(rec: Dict) -> Optional[float]:
    """Share of its roofline that the SSL loss's forward and backward pass
    reaches (``core/losses.ssl_loss`` on the cell's own projections, CUDA
    events over many calls), in %: the least time for the cell's regularizer
    (``bench/counts/decorr_loss.py``) over the measured time."""
    if not rec.get("loss_time_s"):
        return None
    n, d = rec["loss_shape"]
    return 100.0 * decorr_loss.loss_bound_s(n, d, rec["loss"]) / rec["loss_time_s"]
