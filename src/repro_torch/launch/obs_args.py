"""Shared observability wiring for the train CLIs (port of
``repro/launch/obs_args.py``).

The serve CLI exposes ``--metrics-port``/``--alerts``; these helpers give
``repro_torch.launch.train`` the same shape, so a training run is
scrapeable exactly like a serving one:

    obs = build_train_obs(args)                       # None when not asked
    ...
    attach_train_step(obs, step_fn, state, batch)    # the roofline join
    run_training(..., registry=obs.registry if obs else None,
                 perf=obs.perf if obs else None)
    finish_train_obs(args, obs)

``build_train_obs`` returns ``None`` when neither flag was given — default
runs stay completely telemetry-free (no registry on the step path), matching
the previous behavior byte for byte.
"""

from __future__ import annotations

import argparse
import time
import urllib.request
from typing import Optional


def add_obs_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument(
        "--metrics-port", type=int, default=None,
        help="serve /metrics, /alerts, /perf, /flight on this port during "
        "the run (0 = ephemeral); default: no telemetry",
    )
    ap.add_argument(
        "--alerts", action="store_true",
        help="evaluate the default train alert rules (relaxation-gap blowup, "
        "variance collapse) on every scrape",
    )
    return ap


def build_train_obs(args) -> Optional["Obs"]:
    """An enabled ``Obs`` bundle when the CLI asked for telemetry, else
    ``None`` (the run stays exactly as instrumentation-free as before)."""
    if args.metrics_port is None and not args.alerts:
        return None
    from repro_torch.obs import AlertManager, Obs, default_train_rules

    return Obs(alerts=AlertManager(default_train_rules() if args.alerts else ()))


def attach_train_step(obs, step_fn, state, batch) -> bool:
    """Best-effort attribution join for the train step: its op-level
    FLOPs / bytes, analysed on fake copies of the state and the batch
    (``ExecTimer.attach_jit``; the real state is not touched) -> roofline
    gauges.  Never fails the run."""
    if obs is None:
        return False
    try:
        return obs.perf.attach_jit("train_step", step_fn, state, batch)
    except Exception:
        return False


def finish_train_obs(args, obs, *, host: str = "127.0.0.1") -> None:
    """Post-run: start the scrape endpoint, self-scrape once (so the run's
    final state is evaluated against the alert rules and visible even in
    one-shot CLI invocations), report, and shut down."""
    if obs is None:
        return
    server = obs.start_server(port=args.metrics_port or 0, host=host)
    try:
        url = f"http://{host}:{server.port}/metrics"
        with urllib.request.urlopen(url, timeout=5) as resp:
            text = resp.read().decode()
        series = sum(
            1 for ln in text.splitlines() if ln and not ln.startswith("#")
        )
        active = obs.alerts.active()
        print(f"[obs] scraped {series} series from {url}"
              + (f"  ACTIVE ALERTS: {active}" if active else ""))
        top = obs.perf.snapshot(top_k=3)
        for row in top:
            util = row.get("roofline_utilization")
            extra = f"  util={util:.3g}" if util is not None else ""
            print(f"[obs]   {row['executable']}: {row['calls']} calls, "
                  f"total {row['total_s']:.3f}s{extra}")
        if args.metrics_port:
            # a real port was requested: hold the endpoint open briefly so an
            # external scraper pointed at the run can catch the final state
            time.sleep(0.2)
    finally:
        server.stop()
