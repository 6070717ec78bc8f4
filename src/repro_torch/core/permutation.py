"""Feature permutation (paper §4.3), port of ``repro/core/permutation.py``.

One permutation per step, applied identically to both views.  The reference
draws it from JAX's threefry stream, which PyTorch cannot reproduce, so the
port takes explicit indices: ``permutation_for_step`` derives them from a
seeded ``torch.Generator`` (deterministic per (seed, step), like the
reference's ``fold_in``), and a caller comparing with the reference hands in
the reference's own indices instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def permutation_for_step(seed: int, step: int, d: int, device=None) -> Tensor:
    """Deterministic permutation of [0, d) for a given (seed, step)."""
    gen = torch.Generator(device="cpu")
    # one 64-bit seed per (seed, step) pair; the multiplier keeps nearby
    # (seed, step) pairs from colliding
    gen.manual_seed((int(seed) * 0x9E3779B1 + int(step)) % (2**63))
    return torch.randperm(d, generator=gen).to(device)


def permute_features(z: Tensor, perm: Tensor) -> Tensor:
    """Apply a feature permutation along the last axis."""
    return torch.index_select(z, -1, perm.to(device=z.device, dtype=torch.long))


def permute_views(
    perm: Optional[Tensor], z1: Tensor, z2: Optional[Tensor] = None
) -> Tuple[Tensor, Optional[Tensor]]:
    """Apply one permutation to both views (paper Listing 1).

    ``perm=None`` disables permutation (ablation arm).  ``z2 is z1`` stays
    one tensor after the permutation.
    """
    if perm is None:
        return z1, z2
    z1p = permute_features(z1, perm)
    if z2 is None:
        return z1p, None
    return z1p, (z1p if z2 is z1 else permute_features(z2, perm))
