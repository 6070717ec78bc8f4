"""Checkpoint lifecycle: keep-N retention, interval policy, auto-resume
(port of ``repro/checkpoint/manager.py``)."""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional, Tuple

from repro_torch.checkpoint.checkpointer import (
    AsyncCheckpointer,
    latest_step,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
)


class CheckpointManager:
    """Saves every ``interval`` steps (or when forced), keeps the newest
    ``keep`` committed checkpoints, restores the newest one."""

    def __init__(self, ckpt_dir: str, interval: int = 100, keep: int = 3, use_async: bool = True):
        self.ckpt_dir = ckpt_dir
        self.interval = interval
        self.keep = keep
        self._async = AsyncCheckpointer() if use_async else None
        os.makedirs(ckpt_dir, exist_ok=True)
        # collect torn writes of a previous crashed process (safe here: no
        # save of ours is in flight yet): .tmp dirs and dirs without COMMIT
        committed = {f"step_{s}" for s in list_steps(ckpt_dir)}
        for name in os.listdir(ckpt_dir):
            if name.startswith("step_") and name not in committed:
                shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)

    def should_save(self, step: int) -> bool:
        """True on a positive multiple of the interval."""
        return step > 0 and step % self.interval == 0

    def save(self, step: int, state, force: bool = False):
        """Save ``state`` at ``step`` when due (or forced); returns the
        future (async), the directory (sync) or None when not due."""
        if not (force or self.should_save(step)):
            return None
        if self._async is not None:
            # retention runs on the worker once this save has committed
            return self._async.save(self.ckpt_dir, step, state, then=self._gc)
        out = save_checkpoint(self.ckpt_dir, step, state)
        self._gc()
        return out

    def _gc(self):
        steps = list_steps(self.ckpt_dir)
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"), ignore_errors=True)

    def restore_latest(self, template) -> Tuple[Optional[Any], int]:
        """(state, step) of the newest committed checkpoint, or (None, 0)."""
        step = latest_step(self.ckpt_dir)
        if step is None:
            return None, 0
        return restore_checkpoint(self.ckpt_dir, step, template), step

    def wait(self):
        """Drain the async queue."""
        if self._async is not None:
            self._async.wait()
