"""Train loop with checkpoint / restart, preemption, stragglers and retry
(port of ``repro/train/loop.py``).

What the loop adds around the step:
  * auto-resume from the newest committed checkpoint,
  * interval + final + preemption-triggered checkpoints (async, atomic),
  * a straggler watchdog (rolling-median outlier detection),
  * bounded retry of transient step failures (fault injection in tests),
  * deterministic data (batches keyed by step: a restart replays nothing
    and skips nothing).

The step updates the state in place; ``run_training`` returns that same
state.  The reference's telemetry hooks (``registry``, ``monitor``,
``perf``) belong to the port's observability slice and raise here rather
than being ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

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
    """
    for name, hook in (("registry", registry), ("monitor", monitor), ("perf", perf)):
        if hook is not None:
            raise NotImplementedError(
                f"run_training({name}=...) needs the observability slice of the port, which is not ported yet"
            )
    mgr = (
        CheckpointManager(cfg.ckpt_dir, interval=cfg.ckpt_interval, keep=cfg.ckpt_keep)
        if cfg.ckpt_dir
        else None
    )
    preempt = PreemptionSignal(cfg.preempt_flag) if cfg.preempt_flag else None
    watchdog = StragglerWatchdog()

    # auto-resume
    if mgr is not None:
        restored, _ = mgr.restore_latest(state.state_dict())
        if restored is not None:
            state.load_state_dict(restored)

    def one_step(step: int, state: TrainState):
        if fault_hook is not None:
            fault_hook(step)
        return train_step(state, batch_fn(step))

    step_with_retry = with_retries(one_step, max_retries=cfg.max_step_retries)

    try:
        for step in range(state.step, cfg.total_steps):
            watchdog.step_start()
            state, metrics = step_with_retry(step, state)
            watchdog.step_end()

            if log_fn is not None and (step + 1) % cfg.log_interval == 0:
                host_metrics = {k: float(v) for k, v in metrics.items()}
                host_metrics["stragglers"] = watchdog.straggler_events
                log_fn(step + 1, host_metrics)

            if mgr is not None:
                mgr.save(state.step, state.state_dict())

            if preempt is not None and preempt.raised():
                break  # through the final checkpoint below

        if mgr is not None:
            mgr.save(state.step, state.state_dict(), force=True)
    finally:
        # a failed step propagates, but only after the saves in flight landed
        if mgr is not None:
            mgr.wait()
    return state
