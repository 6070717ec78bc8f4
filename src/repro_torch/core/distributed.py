"""Distributed decorrelation — compatibility shim (port of
``repro/core/distributed.py``).

The mode primitives live in ``repro_torch.decorr.modes``; this module
re-exports the reference's historical surface, private names included.
"""

from __future__ import annotations

from repro_torch.decorr.modes import (  # noqa: F401
    all_to_all_features,
    frequency_accumulator,
    grouped_reg_from_freq,
    psum_if,
    r_off_global,
    r_sum_from_psummed,
    r_sum_global,
    r_sum_single_device,
    r_sum_tp,
    reg_from_freq,
)

# Historical private names, kept for any external pin.
_reg_from_freq = reg_from_freq
_grouped_reg_from_freq = grouped_reg_from_freq

__all__ = [
    "all_to_all_features",
    "frequency_accumulator",
    "grouped_reg_from_freq",
    "psum_if",
    "r_off_global",
    "r_sum_from_psummed",
    "r_sum_global",
    "r_sum_single_device",
    "r_sum_tp",
    "reg_from_freq",
]
