"""Optimizers, port of ``repro/optim/optimizers.py``.

* ``lars``  — Layer-wise Adaptive Rate Scaling [arXiv:1708.03888], the
  paper's optimizer.  Bias / norm parameters (ndim < 2) are excluded from
  adaptation and weight decay.
* ``adamw`` — decoupled weight decay Adam.
* ``sgd_momentum``.

Each factory returns an ``Optimizer`` recipe whose ``init(params)`` builds a
``torch.optim.Optimizer`` holding the parameters and their state (the
reference's ``init(params) -> state``).  ``step(lr, grads=None)`` takes the
step's learning rate explicitly, as the reference's ``update(..., lr)``
does, and updates the parameters in place from ``grads`` (one per
parameter, in the optimizer's order, of any float dtype: an f32 gradient
of a bf16 parameter stays f32, as the reference hands it to its update) or,
without them, from their ``.grad``.  The update order and formulas are the
reference's, not ``torch.optim``'s (LARS scales the momentum input by the
trust ratio; AdamW adds the decay to the Adam direction), and each new
parameter is computed in f32 and rounded once to the parameter's dtype.
Nothing here syncs the host: LARS's trust ratio is a ``torch.where`` on
device scalars.

A parameter that holds one shard of a larger tensor (the ``tp``-sharded
projector output layer of ``train/ssl``) carries the process groups it is
sharded over as ``p.shard_groups``: LARS all-reduces the squared norms of
such a parameter and its gradient over them, so the trust ratio is the
whole layer's, and ``clip_by_global_norm(..., params=)`` does the same for
the global norm.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

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

    def __init__(self, params, defaults: Dict[str, Any], buffer_dtype: torch.dtype = torch.float32):
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                for name in self.BUFFERS:
                    self.state[p][name] = torch.zeros_like(p, dtype=buffer_dtype)

    def _params_with_grad(self, grads: Optional[Sequence[Tensor]] = None):
        """(group, param, f32 gradient) for every parameter with a gradient:
        ``grads`` (one per parameter, in order) or else each ``.grad``."""
        pairs = [(group, p) for group in self.param_groups for p in group["params"]]
        if grads is None:
            grads = [p.grad for _, p in pairs]
        elif len(grads) != len(pairs):
            raise ValueError(f"{len(grads)} gradients for {len(pairs)} parameters")
        for (group, p), g in zip(pairs, grads):
            if g is not None:
                yield group, p, g.float()


def _apply(p: Tensor, delta: Tensor) -> None:
    """p <- p - delta, computed in f32 and rounded once to p's dtype (the
    reference's ``(p32 - lr * upd).astype(p.dtype)``)."""
    if p.dtype == torch.float32:
        p.sub_(delta)
    else:
        p.copy_(p.float() - delta)


def _sum_over_shards_(x: Tensor, p: Tensor) -> Tensor:
    """Sum ``x`` in place over the groups parameter ``p`` is sharded over."""
    for group in getattr(p, "shard_groups", ()):
        dist.all_reduce(x, group=group)
    return x


def _norms(p: Tensor, w: Tensor, g: Tensor) -> Tuple[Tensor, Tensor]:
    """(|w|, |g|) of the whole leaf: where ``p`` is a shard, the squared
    norms are summed over its ``shard_groups`` (one all-reduce each)."""
    if not getattr(p, "shard_groups", ()):
        return torch.linalg.vector_norm(w), torch.linalg.vector_norm(g)
    sq = _sum_over_shards_(torch.stack([torch.sum(w * w), torch.sum(g * g)]), p)
    return torch.sqrt(sq[0]), torch.sqrt(sq[1])


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
    def step(self, lr, grads: Optional[Sequence[Tensor]] = None):
        """One update at learning rate ``lr`` (see the module note on ``grads``)."""
        for group, p, g in self._params_with_grad(grads):
            mu = self.state[p]["mu"]
            if _is_adaptive(p):
                p32 = p.float()
                g = g + group["weight_decay"] * p32
                w_norm, g_norm = _norms(p, p32, g)
                trust = torch.where(
                    (w_norm > 0) & (g_norm > 0),
                    group["trust_coefficient"] * w_norm / (g_norm + group["eps"]),
                    torch.ones_like(w_norm),
                )
                g = trust * g
            mu.mul_(group["momentum"]).add_(g)
            _apply(p, lr * mu)


# elements of one leaf that an elementwise update pass works on at a time:
# the update's temporaries are a few copies of what it works on, and a
# billion-element leaf (a large vocabulary's embedding) would need several
# GiB of them at once
_PIECE = 1 << 24


def _pieces(*tensors: Tensor):
    """Matching flat slices of same-shaped contiguous tensors, at most
    ``_PIECE`` elements each (the tensors whole when they are smaller or
    one is not contiguous).  Elementwise arithmetic on the slices gives
    the whole tensors' results bit for bit."""
    n = tensors[0].numel()
    if n <= _PIECE or not all(t.is_contiguous() for t in tensors):
        yield tensors
        return
    flat = [t.view(-1) for t in tensors]
    for i in range(0, n, _PIECE):
        yield tuple(f[i:i + _PIECE] for f in flat)


class AdamW(_Explicit):
    """AdamW with the reference's update: bias-corrected Adam direction plus
    wd p for matrices, p -= lr upd (a large leaf in ``_PIECE``-element
    slices).  Moments of ``moment_dtype``: the update runs in f32 and
    rounds them to it once a step (the reference's ``m32.astype(...)``)."""

    BUFFERS = ("m", "v")

    def __init__(self, params, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, moment_dtype=torch.float32):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, count=0),
                         buffer_dtype=moment_dtype)

    @torch.no_grad()
    def step(self, lr, grads: Optional[Sequence[Tensor]] = None):
        """One update at learning rate ``lr`` (see the module note on ``grads``)."""
        for group in self.param_groups:
            group["count"] += 1
        for group, p, g in self._params_with_grad(grads):
            b1, b2, count = group["b1"], group["b2"], group["count"]
            # bias corrections in f32, as the reference computes them
            c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
            c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
            decay = group["weight_decay"] if _is_adaptive(p) else None
            for ps, gs, m, v in _pieces(p, g, self.state[p]["m"], self.state[p]["v"]):
                m32 = m if m.dtype == torch.float32 else m.float()
                v32 = v if v.dtype == torch.float32 else v.float()
                m32.mul_(b1).add_((1 - b1) * gs)
                v32.mul_(b2).add_((1 - b2) * gs * gs)
                upd = (m32 / c1) / (torch.sqrt(v32 / c2) + group["eps"])
                if decay is not None:
                    upd = upd + decay * ps.float()
                _apply(ps, lr * upd)
                if m32 is not m:
                    m.copy_(m32)
                    v.copy_(v32)


class SGDMomentum(_Explicit):
    """SGD with momentum: g += wd p, mu = m mu + g, p -= lr mu."""

    BUFFERS = ("mu",)

    def __init__(self, params, momentum=0.9, weight_decay=0.0):
        super().__init__(params, dict(momentum=momentum, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, lr, grads: Optional[Sequence[Tensor]] = None):
        """One update at learning rate ``lr`` (see the module note on ``grads``)."""
        for group, p, g in self._params_with_grad(grads):
            mu = self.state[p]["mu"]
            mu.mul_(group["momentum"]).add_(g + group["weight_decay"] * p.float())
            _apply(p, lr * mu)


def lars(momentum=0.9, weight_decay=1e-4, trust_coefficient=0.001, eps=1e-8) -> Optimizer:
    """The paper's optimizer (Barlow Twins / VICReg recipe)."""
    hyper = dict(momentum=momentum, weight_decay=weight_decay, trust_coefficient=trust_coefficient, eps=eps)
    return Optimizer(LARS, tuple(hyper.items()), "lars")


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, moment_dtype=torch.float32) -> Optimizer:
    """Decoupled weight decay Adam (moments of ``moment_dtype``, f32 by
    default; the configs that ask for bf16 moments name it in
    ``ArchConfig.optimizer_moment_dtype``)."""
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, moment_dtype=moment_dtype)
    return Optimizer(AdamW, tuple(hyper.items()), "adamw")


def sgd_momentum(momentum=0.9, weight_decay=0.0) -> Optimizer:
    """SGD with heavy-ball momentum."""
    return Optimizer(SGDMomentum, (("momentum", momentum), ("weight_decay", weight_decay)), "sgd_momentum")


# ---------------------------------------------------------------------------
# Gradient utilities
# ---------------------------------------------------------------------------


def global_norm(tensors: Sequence[Tensor], params: Optional[Sequence[Tensor]] = None) -> Tensor:
    """sqrt(sum of squares) over all tensors, as a device scalar.  With
    ``params`` (the parameters the tensors belong to), a shard's squared
    norm is summed over its parameter's ``shard_groups`` first, so the norm
    is the whole tree's on every rank."""
    if params is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tensors))
    total = None
    for x, p in zip(tensors, params):
        sq = _sum_over_shards_(torch.sum(torch.square(x.float())), p)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(
    grads: Sequence[Tensor], max_norm: float, params: Optional[Sequence[Tensor]] = None
) -> Tuple[List[Tensor], Tensor]:
    """Scale every gradient by min(1, max_norm / (norm + 1e-9)); returns
    (scaled grads, the pre-clip global norm; ``params`` as in
    ``global_norm``).  No host sync."""
    norm = global_norm(grads, params)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads], norm


def clip_by_global_norm_(grads: Sequence[Tensor], max_norm: float,
                         params: Optional[Sequence[Tensor]] = None) -> Tensor:
    """``clip_by_global_norm`` in place: each gradient is scaled where it
    lies, so a step on a model whose gradients fill much of the card never
    holds two copies of them.  Returns the pre-clip global norm (``params``
    as in ``global_norm``: blocks' squares summed over their shard groups)."""
    norm = global_norm(grads, params)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in grads:
        g.mul_(scale)
    return norm


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
