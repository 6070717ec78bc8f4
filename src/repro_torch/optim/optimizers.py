"""Optimizers, port of ``repro/optim/optimizers.py``.

* ``lars``  — Layer-wise Adaptive Rate Scaling [arXiv:1708.03888], the
  paper's optimizer.  Bias / norm parameters (ndim < 2) are excluded from
  adaptation and weight decay.
* ``adamw`` — decoupled weight decay Adam.
* ``sgd_momentum``.

Each factory returns an ``Optimizer`` recipe whose ``init(params)`` builds a
``torch.optim.Optimizer`` holding the parameters and their state (the
reference's ``init(params) -> state``).  ``step(lr)`` takes the step's
learning rate explicitly, as the reference's ``update(..., lr)`` does, and
updates the parameters in place from their ``.grad``.  The update order and
formulas are the reference's, not ``torch.optim``'s (LARS scales the
momentum input by the trust ratio; AdamW adds the decay to the Adam
direction).  Nothing here syncs the host: LARS's trust ratio is a
``torch.where`` on device scalars.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A recipe for an optimizer: ``init(params)`` returns the
    ``torch.optim.Optimizer`` that holds the parameters and their state."""

    cls: type
    hyper: Tuple[Tuple[str, Any], ...]
    name: str = "optimizer"

    def init(self, params: Iterable[Tensor]) -> torch.optim.Optimizer:
        """A fresh optimizer over ``params`` with zeroed state."""
        return self.cls(params, **dict(self.hyper))


def _is_adaptive(p: Tensor) -> bool:
    """LARS adaptation / weight decay applies to matrices, not bias/norm."""
    return p.dim() >= 2


class _Explicit(torch.optim.Optimizer):
    """Base: state buffers made eagerly (so a fresh optimizer's
    ``state_dict`` already has every entry a checkpoint holds), ``step(lr)``."""

    BUFFERS: Sequence[str] = ()

    def __init__(self, params, defaults: Dict[str, Any]):
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                for name in self.BUFFERS:
                    self.state[p][name] = torch.zeros_like(p, dtype=torch.float32)

    def _params_with_grad(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    yield group, p, p.grad.float()


class LARS(_Explicit):
    """LARS with the reference's update: g += wd p and trust = tc |p| /
    (|g| + eps) for matrices, mu = m mu + trust g, p -= lr mu."""

    BUFFERS = ("mu",)

    def __init__(self, params, momentum=0.9, weight_decay=1e-4, trust_coefficient=0.001, eps=1e-8):
        super().__init__(
            params,
            dict(momentum=momentum, weight_decay=weight_decay, trust_coefficient=trust_coefficient, eps=eps),
        )

    @torch.no_grad()
    def step(self, lr):
        """One update at learning rate ``lr`` from the parameters' ``.grad``."""
        for group, p, g in self._params_with_grad():
            mu = self.state[p]["mu"]
            if _is_adaptive(p):
                p32 = p.float()
                g = g + group["weight_decay"] * p32
                w_norm = torch.linalg.vector_norm(p32)
                g_norm = torch.linalg.vector_norm(g)
                trust = torch.where(
                    (w_norm > 0) & (g_norm > 0),
                    group["trust_coefficient"] * w_norm / (g_norm + group["eps"]),
                    torch.ones_like(w_norm),
                )
                g = trust * g
            mu.mul_(group["momentum"]).add_(g)
            p.sub_((lr * mu).to(p.dtype))


class AdamW(_Explicit):
    """AdamW with the reference's update: bias-corrected Adam direction plus
    wd p for matrices, p -= lr upd."""

    BUFFERS = ("m", "v")

    def __init__(self, params, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, count=0))

    @torch.no_grad()
    def step(self, lr):
        """One update at learning rate ``lr`` from the parameters' ``.grad``."""
        for group in self.param_groups:
            group["count"] += 1
        for group, p, g in self._params_with_grad():
            b1, b2, count = group["b1"], group["b2"], group["count"]
            # bias corrections in f32, as the reference computes them
            c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
            c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
            m, v = self.state[p]["m"], self.state[p]["v"]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            upd = (m / c1) / (torch.sqrt(v / c2) + group["eps"])
            if _is_adaptive(p):
                upd = upd + group["weight_decay"] * p.float()
            p.sub_((lr * upd).to(p.dtype))


class SGDMomentum(_Explicit):
    """SGD with momentum: g += wd p, mu = m mu + g, p -= lr mu."""

    BUFFERS = ("mu",)

    def __init__(self, params, momentum=0.9, weight_decay=0.0):
        super().__init__(params, dict(momentum=momentum, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, lr):
        """One update at learning rate ``lr`` from the parameters' ``.grad``."""
        for group, p, g in self._params_with_grad():
            mu = self.state[p]["mu"]
            mu.mul_(group["momentum"]).add_(g + group["weight_decay"] * p.float())
            p.sub_((lr * mu).to(p.dtype))


def lars(momentum=0.9, weight_decay=1e-4, trust_coefficient=0.001, eps=1e-8) -> Optimizer:
    """The paper's optimizer (Barlow Twins / VICReg recipe)."""
    hyper = dict(momentum=momentum, weight_decay=weight_decay, trust_coefficient=trust_coefficient, eps=eps)
    return Optimizer(LARS, tuple(hyper.items()), "lars")


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    """Decoupled weight decay Adam (f32 moments)."""
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return Optimizer(AdamW, tuple(hyper.items()), "adamw")


def sgd_momentum(momentum=0.9, weight_decay=0.0) -> Optimizer:
    """SGD with heavy-ball momentum."""
    return Optimizer(SGDMomentum, (("momentum", momentum), ("weight_decay", weight_decay)), "sgd_momentum")


# ---------------------------------------------------------------------------
# Gradient utilities
# ---------------------------------------------------------------------------


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
    """sqrt(sum of squares) over all tensors, as a device scalar."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tensors))


def clip_by_global_norm(grads: Sequence[Tensor], max_norm: float) -> Tuple[List[Tensor], Tensor]:
    """Scale every gradient by min(1, max_norm / (norm + 1e-9)); returns
    (scaled grads, the pre-clip global norm).  No host sync."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads], norm


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.01):
    """Linear warmup + cosine decay — the paper's schedule.  ``schedule(step)``
    returns a Python float, computed in float32 as the reference computes it."""
    f32 = np.float32

    def schedule(step) -> float:
        s = f32(step)
        if s < warmup_steps:
            return float(f32(lr) * s / f32(max(warmup_steps, 1)))
        prog = np.clip((s - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)), f32(0), f32(1))
        cos = np.cos(f32(math.pi) * prog)
        return float(f32(lr) * (f32(min_ratio) + f32(1 - min_ratio) * f32(0.5) * (f32(1) + cos)))

    return schedule
