"""The paper's losses from their definitions, on the explicit matrix.

Plain PyTorch, float32.  ``C`` is built as a matrix product and every
regularizer is read off it:

* R_off (Eq. 2): the sum of squared off-diagonal entries;
* R_sum (Eq. 5-6): sumvec(C)[k] = sum_i C[i, (i + k) mod d], and
  R = sum over k >= 1 of |sumvec[k]|^q;
* R_sum^(b) (Eq. 13): C cut into b x b blocks, the sumvec of each block,
  component 0 dropped on the diagonal blocks only.

Barlow Twins (Eq. 14) standardizes each view over the batch (biased
variance, eps 1e-5) and adds lam * R to sum_i (1 - C_ii)^2; VICReg
(Eq. 15) is alpha * MSE + (mu / d) * (variance hinges) + (nu / d) * (R of
each view's covariance at n - 1).  The feature permutation of the step
(explicit indices) is applied to the views before R only, as the paper's
Listing 1 applies it.  ``precision`` rounds the products' operands
(``numerics``): the control.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from bench.reference import numerics

Tensor = torch.Tensor


def correlation(z1: Tensor, z2: Tensor, scale: float, precision: str = "fp32") -> Tensor:
    """C = z1^T z2 / scale, (d, d)."""
    return numerics.matmul(z1.T, z2, precision) / scale


def sumvec(c: Tensor) -> Tensor:
    """Summary vectors of square matrices over the last two axes:
    out[..., k] = sum_i c[..., i, (i + k) mod m]."""
    m = c.shape[-1]
    ar = torch.arange(m, device=c.device)
    idx = (ar[:, None] + ar[None, :]) % m  # idx[i, k] = (i + k) mod m
    gathered = torch.gather(c, -1, idx.expand(c.shape))
    return gathered.sum(dim=-2)


def r_off(c: Tensor) -> Tensor:
    """Eq. (2)."""
    return torch.sum(c * c) - torch.sum(torch.diagonal(c) ** 2)


def r_sum(c: Tensor, q: int, block_size: Optional[int] = None) -> Tensor:
    """Eq. (6), or Eq. (13) with blocks of ``block_size`` (d a multiple of it)."""
    d = c.shape[-1]
    power = (lambda s: torch.abs(s)) if q == 1 else (lambda s: s * s)
    if block_size is None or block_size >= d:
        return torch.sum(power(sumvec(c)[1:]))
    b = int(block_size)
    if d % b:
        raise ValueError(f"d = {d} is not a multiple of the block size {b}")
    nb = d // b
    blocks = c.reshape(nb, b, nb, b).permute(0, 2, 1, 3)
    vals = power(sumvec(blocks))  # (nb, nb, b)
    diag0 = torch.diagonal(vals[..., 0])
    return torch.sum(vals) - torch.sum(diag0)


def regularizer(z1: Tensor, z2: Tensor, loss: Dict, scale: float, perm: Optional[Tensor],
                precision: str) -> Tensor:
    """R of the loss's kind on the (already normalized) views."""
    if loss["reg"] == "sum" and loss.get("permute", True) and perm is not None:
        z1, z2 = z1[:, perm], z2[:, perm]
    c = correlation(z1, z2, scale, precision)
    if loss["reg"] == "off":
        return r_off(c)
    return r_sum(c, int(loss.get("q", 2)), loss.get("block_size"))


def barlow_twins(z1: Tensor, z2: Tensor, loss: Dict, perm: Optional[Tensor], precision: str = "fp32") -> Tensor:
    """Eq. (14) on raw projections z1, z2 (n, d)."""
    eps = float(loss.get("eps", 1e-5))
    n = z1.shape[0]

    def standardize(z):
        mean = z.mean(dim=0, keepdim=True)
        var = ((z - mean) ** 2).mean(dim=0, keepdim=True)
        return (z - mean) / torch.sqrt(var + eps)

    a, b = standardize(z1.float()), standardize(z2.float())
    cii = torch.sum(a * b, dim=0) / n
    invariance = torch.sum((1.0 - cii) ** 2)
    return invariance + float(loss.get("lam", 2.0 ** -10)) * regularizer(a, b, loss, float(n), perm, precision)


def vicreg(z1: Tensor, z2: Tensor, loss: Dict, perm: Optional[Tensor], precision: str = "fp32") -> Tensor:
    """Eq. (15) on raw projections z1, z2 (n, d)."""
    z1, z2 = z1.float(), z2.float()
    n, d = z1.shape
    gamma = float(loss.get("gamma", 1.0))
    invariance = torch.sum((z1 - z2) ** 2) / n

    def hinge(z):
        var = torch.sum((z - z.mean(dim=0, keepdim=True)) ** 2, dim=0) / max(n - 1, 1)
        return torch.sum(torch.relu(gamma - torch.sqrt(var + 1e-4)))

    c1 = z1 - z1.mean(dim=0, keepdim=True)
    c2 = z2 - z2.mean(dim=0, keepdim=True)
    scale = float(max(n - 1, 1))
    reg = regularizer(c1, c1, loss, scale, perm, precision) + regularizer(c2, c2, loss, scale, perm, precision)
    return (float(loss.get("alpha", 25.0)) * invariance + float(loss.get("mu", 25.0)) / d * (hinge(z1) + hinge(z2))
            + float(loss.get("nu", 1.0)) / d * reg)


def ssl_loss(z1: Tensor, z2: Tensor, loss: Dict, perm: Optional[Tensor], precision: str = "fp32") -> Tensor:
    """Barlow Twins or VICReg by ``loss["style"]``."""
    fn = barlow_twins if loss.get("style", "bt") == "bt" else vicreg
    return fn(z1, z2, loss, perm, precision)


def lm_aux(hidden: Tensor, aux: Dict, perm: Optional[Tensor], precision: str = "fp32") -> Tensor:
    """The LM's auxiliary loss (single view): (mu / d) * the variance hinge
    + (nu / d) * R of the covariance, on ``tokens_per_seq`` rows a sequence
    taken at an even stride.  ``hidden``: (B, S, d) final hidden states."""
    b, s, d = hidden.shape
    take = min(s, int(aux.get("tokens_per_seq", 8)))
    stride = max(1, s // take)
    z = hidden[:, ::stride, :][:, :take, :].reshape(b * take, d).float()
    n = z.shape[0]
    gamma = float(aux.get("gamma", 1.0))
    zc = z - z.mean(dim=0, keepdim=True)
    var = torch.sum(zc * zc, dim=0) / max(n - 1, 1)
    hinge = torch.sum(torch.relu(gamma - torch.sqrt(var + 1e-4)))
    reg = regularizer(zc, zc, aux, float(max(n - 1, 1)), perm, precision)
    return float(aux.get("mu", 1.0)) / d * hinge + float(aux.get("nu", 0.04)) / d * reg
