"""Train loop with checkpoint / restart, preemption, stragglers and retry
(port of ``repro/train/loop.py``).

What the loop adds around the step:
  * auto-resume from the newest committed checkpoint,
  * interval + final + preemption-triggered checkpoints (async, atomic;
    no final one when no step ran since the newest),
  * a straggler watchdog (rolling-median outlier detection),
  * bounded retry of transient step failures (fault injection in tests),
  * deterministic data (batches keyed by step: a restart replays nothing
    and skips nothing).

The step updates the state in place; ``run_training`` returns that same
state.  The telemetry hooks are the reference's: per-phase wall-time
histograms and a step counter in a ``registry``, ``train_``-prefixed gauges,
the parameter norm and a health ``monitor``'s probe at log intervals, and
the step's time in a ``perf`` timer (which waits for the step's device
work, so the time includes it).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.ft.watchdog import PreemptionSignal, StragglerWatchdog, with_retries
from repro_torch.train.train_state import TrainState


@dataclasses.dataclass
class LoopConfig:
    """Steps, checkpoint policy, logging cadence, preemption flag, retries."""

    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_interval: int = 50
    ckpt_keep: int = 3
    log_interval: int = 10
    preempt_flag: Optional[str] = None
    max_step_retries: int = 2
    # False on every rank of a multi-rank job but the one that writes: the
    # others restore, and take part in a sharded state's gathers, but write
    # nothing
    ckpt_writer: bool = True


def run_training(
    state: TrainState,
    train_step: Callable,
    batch_fn: Callable[[int], Any],
    cfg: LoopConfig,
    log_fn: Optional[Callable[[int, Dict], None]] = None,
    fault_hook: Optional[Callable[[int], None]] = None,
    registry=None,
    monitor=None,
    perf=None,
) -> TrainState:
    """Run ``train_step`` from the state's (or the newest checkpoint's) step
    up to ``cfg.total_steps``.

    ``batch_fn(step)`` returns a device-ready batch, deterministic per step.
    ``fault_hook(step)`` may raise RuntimeError to simulate a transient
    fault.  ``log_fn(step, metrics)`` gets host floats every
    ``log_interval`` steps (the only host sync the loop adds).
    ``registry`` (a ``repro_torch.obs.MetricsRegistry``) gets per-phase
    wall-time histograms (batch fetch / train step / log-interval publish)
    and a step counter every step, and ``train_``-prefixed gauges of the
    metrics plus the global parameter-norm gauge at each log interval.
    ``monitor`` (a ``repro_torch.obs.DecorrHealthMonitor``) probes the
    current model against the step's batch at each log interval.  ``perf``
    (a ``repro_torch.obs.ExecTimer``) times each step as ``train_step``,
    waiting for its device work first.
    """
    mgr = (
        CheckpointManager(cfg.ckpt_dir, interval=cfg.ckpt_interval, keep=cfg.ckpt_keep, writer=cfg.ckpt_writer)
        if cfg.ckpt_dir
        else None
    )
    preempt = PreemptionSignal(cfg.preempt_flag) if cfg.preempt_flag else None
    watchdog = StragglerWatchdog()
    h_step = c_steps = h_batch = h_publish = None
    if registry is not None:
        h_step = registry.histogram("train_step_seconds", "one train step wall time")
        c_steps = registry.counter("train_steps_total", "train steps run")
        h_batch = registry.histogram("train_batch_seconds", "batch fetch wall time")
        h_publish = registry.histogram("train_publish_seconds", "log-interval publish + health-probe wall time")

    # auto-resume
    saved = None  # the step the newest checkpoint holds
    if mgr is not None:
        restored, _ = mgr.restore_latest(state.state_dict())
        if restored is not None:
            state.load_state_dict(restored)
            saved = state.step

    # phase timings land in a cell so one_step keeps the (state, metrics)
    # return contract with_retries wraps
    phase = {"batch_s": 0.0, "step_s": 0.0}

    def one_step(step: int, state: TrainState):
        if fault_hook is not None:
            fault_hook(step)
        t0 = time.perf_counter()
        batch = batch_fn(step)
        t1 = time.perf_counter()
        out = train_step(state, batch)
        if perf is not None:
            perf.block(_device_of(state))
        phase["batch_s"] = t1 - t0
        phase["step_s"] = time.perf_counter() - t1
        return out

    step_with_retry = with_retries(one_step, max_retries=cfg.max_step_retries)

    try:
        for step in range(state.step, cfg.total_steps):
            watchdog.step_start()
            state, metrics = step_with_retry(step, state)
            watchdog.step_end()
            if registry is not None:
                h_step.observe(watchdog.durations[-1])
                h_batch.observe(phase["batch_s"])
                c_steps.inc()
            if perf is not None:
                perf.observe("train_step", phase["step_s"])

            at_log = (step + 1) % cfg.log_interval == 0
            if at_log and (log_fn is not None or registry is not None or monitor is not None):
                t_pub = time.perf_counter()
                host_metrics = {k: float(v) for k, v in metrics.items()}
                host_metrics["stragglers"] = watchdog.straggler_events
                if registry is not None:
                    registry.publish({f"train_{k}": v for k, v in host_metrics.items()})
                    registry.gauge("train_step_seconds_median").set(watchdog.median)
                    _publish_param_norm(registry, state)
                if monitor is not None:
                    monitor.update(state, batch_fn(step), step=step + 1, registry=registry)
                if log_fn is not None:
                    log_fn(step + 1, host_metrics)
                if h_publish is not None:
                    h_publish.observe(time.perf_counter() - t_pub)

            if mgr is not None and mgr.should_save(state.step):
                # the tree is built only when due: a sharded state gathers it
                mgr.save(state.step, state.state_dict())
                saved = state.step

            if preempt is not None and preempt.raised():
                break  # through the final checkpoint below

        # no step since the newest checkpoint: it holds this state already, and
        # rewriting it could pull it from under a rank still restoring it
        if mgr is not None and state.step != saved:
            mgr.save(state.step, state.state_dict(), force=True)
    finally:
        # a failed step propagates, but only after the saves in flight landed
        if mgr is not None:
            mgr.wait()
    return state


def _device_of(state):
    """The device of the state's parameters (None for a duck-typed state)."""
    model = getattr(state, "model", None)
    if model is None:
        return None
    for p in model.parameters():
        return p.device
    return None


def _publish_param_norm(registry, state):
    """Global L2 norm of the parameters as a gauge.  A duck-typed state
    without a model (tests pass step-only stand-ins) publishes nothing."""
    model = getattr(state, "model", None)
    if model is None:
        return
    params = [p.detach() for p in model.parameters()]
    if not params:
        return
    sq = torch.stack([torch.sum(p.float() * p.float()) for p in params]).sum()
    registry.gauge("train_param_norm", "global L2 norm of the params").set(float(sq) ** 0.5)
