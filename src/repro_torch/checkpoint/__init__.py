"""Atomic, async checkpoints of nested state dicts (port of ``repro.checkpoint``)."""

from repro_torch.checkpoint.checkpointer import (
    AsyncCheckpointer,
    latest_step,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.manager import CheckpointManager
