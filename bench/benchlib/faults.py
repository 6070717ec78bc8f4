"""Faults planted under the timed path, to show that the comparison fails them.

Each fault replaces the system's step factory for the duration of a
``with`` block, so a whole run (set-up's first steps, the window, the
check) goes through the broken step:

* ``unchanged``: a step that computes the loss and returns its state as it
  was (no gradient applied, the step counter and the optimizer untouched);
* ``half_batch``: the step is given the first half of the batch's rows, so
  the loss and the gradients are means over the rest.

The bench's tests plant them on the CPU; ``bench/calibrate.py`` plants
``half_batch`` on the card.
"""

from __future__ import annotations

import contextlib
from typing import Dict

FACTORIES = {
    "ssl_train": ("repro_torch.train.ssl", "make_ssl_train_step"),
    "lm_train": ("repro_torch.train.step", "make_train_step"),
}


def _half(batch: Dict) -> Dict:
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def _broken(driver: str, fault: str, factory):
    import torch

    def make(*args, **kwargs):
        made = factory(*args, **kwargs)
        step = made[0] if driver == "ssl_train" else made
        if fault == "half_batch":
            def broken(state, batch):
                return step(state, _half(batch))
        elif fault == "unchanged":
            if driver == "ssl_train":
                loss_fn = made[1]

                def broken(state, batch):
                    with torch.no_grad():
                        _, metrics = loss_fn(state.model, batch, None)
                    return state, metrics
            else:
                from repro_torch.train.step import _lm_loss_fn

                cfg = args[0]

                def broken(state, batch):
                    with torch.no_grad():
                        _, metrics = _lm_loss_fn(state.model.tree(), batch, cfg)
                    return state, metrics
        else:
            raise ValueError(f"unknown fault {fault!r}")
        return (broken, made[1]) if driver == "ssl_train" else broken

    return make


@contextlib.contextmanager
def planted(driver: str, fault: str):
    """Inside the block, the system's step of ``driver`` carries ``fault``."""
    import importlib

    mod_name, attr = FACTORIES[driver]
    mod = importlib.import_module(mod_name)
    original = getattr(mod, attr)
    setattr(mod, attr, _broken(driver, fault, original))
    try:
        yield
    finally:
        setattr(mod, attr, original)
