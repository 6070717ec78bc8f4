"""The least work of one SSL loss's forward and backward pass on two
(n, d) float32 views, from (n, d, b, q) and the regularizer alone.

Bytes: each input read once and each output written once: the two views
in, the loss out, the two views' gradients out (4 n d floats).

FLOPs, forward (the backward counted as twice the forward, so x 3):

* R_off: C = Z1^T Z2, 2 n d^2;
* R_sum, ungrouped (b = d): two real FFTs of n rows of length d, 2.5 d
  log2 d each, and the frequency products summed over the rows, 8 flops a
  complex multiply-add on d / 2 + 1 bins; q = 1 adds an inverse FFT of
  one length-d vector (negligible, counted);
* R_sum^(b): the FFTs of the d / b blocks of each row (2.5 b log2 b each)
  and every pair of blocks' products, 8 (d / b)^2 (b / 2 + 1) a row.

The standardization, the invariance term and the permutation are O(n d)
and covered by the bytes.  VICReg's regularizer runs on each view against
itself: twice the products, the same bytes.  The bound is the larger of
FLOPs at the float32 peak and bytes at the memory bandwidth.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

from bench.counts import peaks


def forward_flops(n: int, d: int, reg: str, block_size: Optional[int] = None, q: int = 2) -> float:
    """FLOPs of one regularizer's forward pass on a pair of views."""
    if reg == "off":
        return 2.0 * n * d * d
    b = d if block_size is None or block_size >= d else int(block_size)
    nb = d // b
    ffts = 2 * n * nb * 2.5 * b * math.log2(b)
    products = 8.0 * n * nb * nb * (b // 2 + 1)
    inverse = 2.5 * d * math.log2(d) if q == 1 and b == d else 0.0
    return ffts + products + inverse


def loss_flops(n: int, d: int, loss: Dict) -> float:
    """Forward and backward FLOPs of the whole loss."""
    pairs = 2 if loss.get("style", "bt") == "vic" else 1
    return 3.0 * pairs * forward_flops(n, d, loss["reg"], loss.get("block_size"), int(loss.get("q", 2)))


def loss_bytes(n: int, d: int) -> float:
    """Bytes read and written at least: two views in, their gradients out, f32."""
    return 4.0 * n * d * 4


def loss_bound_s(n: int, d: int, loss: Dict) -> float:
    """The least time of the loss's forward and backward pass on one H100."""
    return max(loss_flops(n, d, loss) / peaks.F32_FLOPS, loss_bytes(n, d) / peaks.HBM_BYTES_PER_S)
