"""Plain optimizers, schedule and feature permutation of the reference.

The formulas are the paper's recipe as the system under test states them
(its reference package's update order): LARS scales its momentum input by
the trust ratio, AdamW adds the decay to the bias-corrected Adam
direction, and decay and trust apply to leaves of two or more dimensions.
Every update is computed in float32 on float32 parameters.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

Tensor = torch.Tensor


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.01):
    """Linear warm-up, then cosine decay to ``min_ratio`` of the peak,
    computed in float32."""
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        if s < warmup_steps:
            return float(f32(lr) * s / f32(max(warmup_steps, 1)))
        prog = np.clip((s - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)), f32(0), f32(1))
        cos = np.cos(f32(math.pi) * prog)
        return float(f32(lr) * (f32(min_ratio) + f32(1 - min_ratio) * f32(0.5) * (f32(1) + cos)))

    return schedule


def permutation(seed: int, step: int, d: int, device=None) -> Tensor:
    """The step's feature permutation as the system derives it: a
    ``torch.randperm`` of a CPU generator seeded with
    (seed * 0x9E3779B1 + step) mod 2^63."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed((int(seed) * 0x9E3779B1 + int(step)) % (2**63))
    return torch.randperm(d, generator=gen).to(device)


class LARS:
    """g += wd p and trust = tc |p| / (|g| + eps) on matrices (1 where a
    norm is 0), mu = m mu + trust g, p -= lr mu."""

    def __init__(self, params: List[Tensor], momentum=0.9, weight_decay=1e-4, trust_coefficient=1e-3, eps=1e-8):
        self.params = params
        self.hyper = dict(momentum=momentum, weight_decay=weight_decay, tc=trust_coefficient, eps=eps)
        self.mu = [torch.zeros_like(p) for p in params]
        self.taken: Optional[List[Tensor]] = None

    @torch.no_grad()
    def step(self, lr: float, grads: List[Tensor]) -> None:
        h = self.hyper
        if self.taken is None:
            self.taken = [g.float() for g in grads]
        for p, g, mu in zip(self.params, grads, self.mu):
            g = g.float()
            if p.dim() >= 2:
                g = g + h["weight_decay"] * p
                wn, gn = torch.linalg.vector_norm(p), torch.linalg.vector_norm(g)
                trust = torch.where((wn > 0) & (gn > 0), h["tc"] * wn / (gn + h["eps"]), torch.ones_like(wn))
                g = trust * g
            mu.mul_(h["momentum"]).add_(g)
            p.sub_(lr * mu)

    def first_gradients(self) -> List[Tensor]:
        """The gradient as the first update took it, kept by that update
        (the momentum after one step is trust-scaled on matrices, and its
        norm there is about tc |p| whatever the gradient)."""
        return list(self.taken)


class AdamW:
    """m, v with bias corrections in float32; upd = m^ / (sqrt(v^) + eps)
    + wd p on matrices; p -= lr upd."""

    def __init__(self, params: List[Tensor], b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
        self.params = params
        self.hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, lr: float, grads: List[Tensor]) -> None:
        h = self.hyper
        self.count += 1
        c1 = float(np.float32(1.0) - np.float32(h["b1"]) ** np.float32(self.count))
        c2 = float(np.float32(1.0) - np.float32(h["b2"]) ** np.float32(self.count))
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = g.float()
            m.mul_(h["b1"]).add_((1 - h["b1"]) * g)
            v.mul_(h["b2"]).add_((1 - h["b2"]) * g * g)
            upd = (m / c1) / (torch.sqrt(v / c2) + h["eps"])
            if p.dim() >= 2:
                upd = upd + h["weight_decay"] * p
            p.sub_(lr * upd)

    def first_gradients(self):
        """The gradient as the update took it, read from the state after
        one step: m / (1 - b1), one leaf at a time."""
        return (m / (1 - self.hyper["b1"]) for m in self.m)


def clip_(grads: List[Tensor], max_norm: Optional[float]) -> Optional[Tensor]:
    """Scale the gradients in place to a global norm of at most
    ``max_norm`` (factor min(1, max_norm / (norm + 1e-9))); returns the
    norm before, or None without a clip."""
    if max_norm is None:
        return None
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in grads:
        g.mul_(scale)
    return norm


def make(name: str, params: List[Tensor], hyper: Dict):
    """The optimizer ``name`` ("lars" or "adamw") over ``params``."""
    cls = {"lars": LARS, "adamw": AdamW}[name]
    return cls(params, **hyper)


def leaf_norms(tensors) -> List[float]:
    """Each tensor's Euclidean norm (float32 sums), as host floats."""
    return [float(torch.linalg.vector_norm(t.float())) for t in tensors]
