"""Train state (port of ``repro/train/train_state.py``).

The reference's ``TrainState`` is an immutable pytree (step, params,
opt_state, rng).  Here the model and the optimizer hold their tensors and
are updated in place; the state is the step counter, the model, the
optimizer (``opt_state``) and the seed the per-step permutations derive
from.  ``state_dict`` / ``load_state_dict`` give the checkpointable tree.

``ShardedTrainState`` is the state of one rank of a sharded run (the
``tp``-sharded SSL projector): its ``state_dict`` gathers every sharded
parameter and its optimizer buffers into the full tree — the tree an
unsharded run writes — and ``load_state_dict`` cuts this rank's blocks out
of such a tree.  Both are collectives: every rank calls them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
from torch import nn

from repro_torch.optim.optimizers import Optimizer
from repro_torch.parallel.sharding import NamedSharding


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


@dataclasses.dataclass
class ShardedTrainState(TrainState):
    """``TrainState`` of one rank whose parameters named in ``shardings``
    hold blocks of larger tensors (the others are replicated)."""

    shardings: Dict[str, NamedSharding] = dataclasses.field(default_factory=dict)

    def _map_sharded(self, tree: Dict[str, Any], fn: Callable[[NamedSharding, torch.Tensor], torch.Tensor]):
        """A copy of ``tree`` with ``fn`` applied to every sharded parameter
        and to each of its optimizer buffers (the state of the i-th
        parameter is keyed by i); ``tree`` itself is left as it was."""
        names = [name for name, _ in self.model.named_parameters()]
        params = dict(tree["params"])
        state = dict(tree["opt_state"]["state"])
        for name, sharding in self.shardings.items():
            params[name] = fn(sharding, params[name])
            i = names.index(name)
            if i in state:
                state[i] = {k: fn(sharding, v) if isinstance(v, torch.Tensor) and v.dim() > 0 else v
                            for k, v in state[i].items()}
        return dict(tree, params=params, opt_state=dict(tree["opt_state"], state=state))

    def state_dict(self) -> Dict[str, Any]:
        """The full tree, every rank's blocks gathered (a collective)."""
        return self._map_sharded(super().state_dict(), lambda sh, x: sh.gather(x))

    def load_state_dict(self, tree: Dict[str, Any]) -> None:
        """Restore this rank's blocks of a full tree in place."""
        super().load_state_dict(self._map_sharded(tree, lambda sh, x: sh.local(x)))
