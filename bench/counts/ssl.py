"""Model FLOPs of an SSL training step: 6 x (the parameters of the
backbone's and projector's matrices) x (rows stepped: both views of the
batch).  Biases, activations, the loss and the optimizer are not counted,
as a model FLOP utilization counts them."""

from __future__ import annotations

from typing import Dict


def gemm_params(config: Dict) -> int:
    """Entries of every weight matrix of the MLP."""
    dims = [config["input_dim"], *config["backbone_widths"], *config["projector_widths"]]
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def step_flops(config: Dict, batch: int) -> float:
    """Forward and backward FLOPs of one step on ``batch`` rows of each of
    the two views."""
    return 6.0 * gemm_params(config) * 2 * batch
