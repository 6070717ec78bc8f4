"""Plain reference of the SSL training step: an MLP backbone (ReLU after
every layer) and projector (ReLU after every layer but the last), the
paper's loss from the explicit matrix (``decorr``), LARS.

``follow`` runs the first steps from the weights and batches the
benchmark made, in float32 (or the control's precision), and returns the
readings the comparison needs.  It imports nothing of the system under
test.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

from bench.reference import decorr, numerics
from bench.reference import optim as ref_optim

Tensor = torch.Tensor


def mlp(layers: Sequence[Tuple[Tensor, Tensor]], x: Tensor, last_relu: bool, precision: str) -> Tensor:
    """x -> relu(x W^T + b) for each (W (out, in), b) layer; the last
    layer's ReLU only where ``last_relu``."""
    h = x.float()
    for i, (w, b) in enumerate(layers):
        h = numerics.matmul(h, w.T, precision) + b
        if last_relu or i < len(layers) - 1:
            h = torch.relu(h)
    return h


def embed(params: Sequence[Tensor], n_backbone: int, x: Tensor, precision: str) -> Tensor:
    """Backbone then projector; ``params`` is the flat sequence (W0, b0, W1,
    b1, ...), the backbone's ``n_backbone`` layers first."""
    layers = list(zip(params[0::2], params[1::2]))
    h = mlp(layers[:n_backbone], x, True, precision)
    return mlp(layers[n_backbone:], h, False, precision)


def follow(
    params: Dict[str, Tensor],
    n_backbone: int,
    batches: Sequence[Dict[str, Tensor]],
    perms: Sequence[Tensor],
    loss: Dict,
    optimizer: Tuple[str, Dict],
    schedule: Callable[[int], float],
    precision: str = "fp32",
) -> Dict:
    """Steps 0 .. len(batches) - 1 from ``params`` (float32 leaves by name,
    in layer order, updated in place).  Returns {"losses": per step;
    "first_grads": by leaf, the norm of the gradient as the optimizer took
    it at step 0; "grads": by leaf, the norm of step 0's raw gradient;
    "changes": by leaf, the norm of the change over all the steps}."""
    if precision == "fp32":
        numerics.float32_exact()
    names = list(params)
    start = [params[n].detach().clone() for n in names]
    leaves = [params[n].detach().float().requires_grad_(True) for n in names]
    opt = ref_optim.make(optimizer[0], leaves, optimizer[1])
    losses, first, raw = [], None, None
    for step, (batch, perm) in enumerate(zip(batches, perms)):
        z1 = embed(leaves, n_backbone, batch["view1"], precision)
        z2 = embed(leaves, n_backbone, batch["view2"], precision)
        value = decorr.ssl_loss(z1, z2, loss, perm, precision)
        grads = list(torch.autograd.grad(value, leaves))
        losses.append(float(value.detach()))
        if step == 0:
            raw = dict(zip(names, ref_optim.leaf_norms(grads)))
        opt.step(schedule(step), grads)
        if step == 0:
            first = dict(zip(names, ref_optim.leaf_norms(opt.first_gradients())))
    changes = dict(zip(names, ref_optim.leaf_norms(p.detach() - s for p, s in zip(leaves, start))))
    return {"losses": losses, "first_grads": first, "grads": raw, "changes": changes}
