"""Whitening-based decorrelation baseline (paper §2, the W-MSE / Zero-CL
family), port of ``repro/core/whitening.py``: whiten the features with an
inverse covariance square root instead of regularizing them.

The paper's complexity argument is that whitening needs the d x d
covariance and its inverse square root — O(n d^2 + d^3) per step — which is
exactly what R_sum avoids.  ZCA whitening through a coupled Newton–Schulz
iteration (matmuls only, no eigendecomposition) and the W-MSE loss, in
plain PyTorch: the reference has no kernel here either.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensor = torch.Tensor


def newton_schulz_inv_sqrt(mat: Tensor, iters: int = 7, eps: float = 1e-5) -> Tensor:
    """Matmul-only inverse square root of an SPD matrix.

    Coupled Newton–Schulz: Y_{k+1} = Y_k T_k, Z_{k+1} = T_k Z_k with
    T_k = (3I - Z_k Y_k) / 2, from Y_0 = A / ||A||_F, Z_0 = I: Y tends to
    A^{1/2} / sqrt(||A||), Z to A^{-1/2} sqrt(||A||).
    """
    d = mat.shape[-1]
    ident = torch.eye(d, dtype=torch.float32, device=mat.device)
    a = mat.float() + eps * ident
    norm = torch.linalg.norm(a)
    y = a / norm
    z = ident
    for _ in range(iters):
        t = 0.5 * (3.0 * ident - z @ y)
        y, z = y @ t, t @ z
    return z / torch.sqrt(norm)


def zca_whiten(z: Tensor, eps: float = 1e-5, iters: int = 7) -> Tensor:
    """Whiten (n, d) embeddings: the output's covariance is (nearly) the
    identity.  O(n d^2 + d^3 through matmuls) — the cost the paper's
    O(n d log d) regularizer avoids."""
    n = z.shape[0]
    zc = z.float() - torch.mean(z.float(), dim=0, keepdim=True)
    cov = (zc.T @ zc) / max(n - 1, 1)
    return zc @ newton_schulz_inv_sqrt(cov, iters=iters, eps=eps)


def wmse_loss(z1: Tensor, z2: Tensor, eps: float = 1e-5) -> Tuple[Tensor, Dict[str, Tensor]]:
    """W-MSE-style loss: whiten each view, normalize the rows, then align
    them (mean squared distance)."""
    w1 = zca_whiten(z1, eps)
    w2 = zca_whiten(z2, eps)
    w1 = w1 / (torch.linalg.norm(w1, dim=-1, keepdim=True) + 1e-9)
    w2 = w2 / (torch.linalg.norm(w2, dim=-1, keepdim=True) + 1e-9)
    loss = torch.mean(torch.sum((w1 - w2) ** 2, dim=-1))
    return loss, {"wmse_loss": loss}
