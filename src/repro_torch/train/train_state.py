"""Train state (port of ``repro/train/train_state.py``).

The reference's ``TrainState`` is an immutable pytree (step, params,
opt_state, rng).  Here the model and the optimizer hold their tensors and
are updated in place; the state is the step counter, the model, the
optimizer (``opt_state``) and the seed the per-step permutations derive
from.  ``state_dict`` / ``load_state_dict`` give the checkpointable tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn

from repro_torch.optim.optimizers import Optimizer


@dataclasses.dataclass
class TrainState:
    """step: updates applied so far; model; opt_state: the optimizer bound
    to ``model``'s parameters; seed: the permutation stream's seed."""

    step: int
    model: nn.Module
    opt_state: torch.optim.Optimizer
    seed: int = 0

    def state_dict(self) -> Dict[str, Any]:
        """The checkpointable tree: step, seed, params and optimizer state."""
        return {
            "step": int(self.step),
            "seed": int(self.seed),
            "params": self.model.state_dict(),
            "opt_state": self.opt_state.state_dict(),
        }

    def load_state_dict(self, tree: Dict[str, Any]) -> None:
        """Restore in place from ``state_dict()``'s tree."""
        self.step = int(tree["step"])
        self.seed = int(tree["seed"])
        self.model.load_state_dict(tree["params"])
        self.opt_state.load_state_dict(tree["opt_state"])


def create_train_state(model: nn.Module, optimizer: Optimizer, seed: int = 0) -> TrainState:
    """Step 0, a fresh optimizer over ``model``'s parameters."""
    return TrainState(step=0, model=model, opt_state=optimizer.init(model.parameters()), seed=seed)
