"""Precision of the plain reference: float32, or a control below it.

The reference computes in float32 with TF32 off.  Its control is the same
arithmetic with every matrix product's operands rounded to the precision
just below the configuration's own, so that the comparison can be shown to
fail:

* ``"tf32"`` (control of a float32 configuration): operands rounded to
  TF32's 10-bit mantissa, to nearest, then multiplied in float32, which is
  what a TF32 tensor-core product does to its inputs;
* ``"fp8"`` (control of a bfloat16 configuration): operands scaled per
  tensor to float8 e4m3's range (largest magnitude 448), rounded to it and
  scaled back, then multiplied in float32; and every activation that a
  bfloat16 model holds in its compute dtype (``activation``) rounded the
  same way, so the control computes in float8 where the system computes
  in bfloat16.

The rounding is done here on the values, so the control reads the same on
the CPU as on the card.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor
PRECISIONS = ("fp32", "tf32", "fp8")
FP8_MAX = 448.0


def float32_exact() -> None:
    """Turn TF32 off for float32 products (the reference's own precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: Tensor) -> Tensor:
    """float32 values rounded to nearest at 10 mantissa bits (ties away)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: Tensor) -> Tensor:
    """Values rounded to float8 e4m3 under one per-tensor scale."""
    x = x.float()
    amax = x.detach().abs().max()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def rounder(precision: str):
    """The operand rounding of ``precision`` (identity for ``"fp32"``).
    Its gradient passes straight through (the rounding is a forward-only
    perturbation, as a lower-precision product's is)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision == "fp32":
        return lambda x: x.float()
    fn = round_tf32 if precision == "tf32" else round_fp8

    def rnd(x: Tensor) -> Tensor:
        x = x.float()
        return x + (fn(x) - x).detach()

    return rnd


def activation(precision: str):
    """The rounding of the activations a low-precision model holds: float8
    for ``"fp8"``; none for ``"fp32"`` and ``"tf32"`` (TF32 rounds only a
    product's inputs)."""
    return rounder("fp8") if precision == "fp8" else rounder("fp32")


def matmul(a: Tensor, b: Tensor, precision: str = "fp32") -> Tensor:
    """a @ b in float32 with both operands rounded to ``precision``."""
    rnd = rounder(precision)
    return rnd(a) @ rnd(b)
