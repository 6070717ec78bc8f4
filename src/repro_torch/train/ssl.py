"""The paper's SSL setting: MLP backbone + projector trained with Barlow
Twins / VICReg-style losses (port of ``repro/train/ssl.py``, single device).

``SSLModel`` is an ``nn.Module`` with ``backbone`` and ``projector``
``nn.Linear`` stacks: ReLU after every backbone layer and after every
projector layer but the last.  ``params_from_jax`` loads the reference's
``{"backbone": [{"w", "b"}...], "projector": [...]}`` parameter tree (as
numpy arrays) into it, so the port and the reference compute the same
embeddings.  The reference stores ``w`` as (in, out); ``nn.Linear`` keeps
(out, in).

``make_ssl_train_step`` is the reference's step: loss and gradients by
autograd (through the kernels' own vjps on a CUDA device), optional global
norm clipping, lr = schedule(step), then the optimizer update.  The
mesh-aware variant belongs to the distributed slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.losses import ssl_loss
from repro_torch.core.permutation import permutation_for_step
from repro_torch.decorr.config import DecorrConfig
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm
from repro_torch.train.train_state import TrainState

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SSLModelConfig:
    """Widths of the SSL model (defaults: the ``ssl-paper`` configuration)."""

    input_dim: int = 3072
    backbone_widths: Tuple[int, ...] = (512, 512)
    projector_widths: Tuple[int, ...] = (2048, 2048, 2048)


def _linears(dims: Sequence[int]) -> nn.ModuleList:
    return nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))


class SSLModel(nn.Module):
    """Backbone + projector; ``forward`` (== ``embed``) maps (n, input_dim) -> (n, d)."""

    def __init__(self, cfg: SSLModelConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = _linears((cfg.input_dim,) + tuple(cfg.backbone_widths))
        self.projector = _linears((cfg.backbone_widths[-1],) + tuple(cfg.projector_widths))

    @property
    def d(self) -> int:
        """Embedding width (the projector's output dimension)."""
        return int(self.cfg.projector_widths[-1])

    def backbone_apply(self, x: Tensor) -> Tensor:
        """ReLU MLP backbone."""
        h = x
        for layer in self.backbone:
            h = torch.relu(layer(h))
        return h

    def projector_apply(self, h: Tensor) -> Tensor:
        """MLP projector, no activation after the last layer."""
        last = len(self.projector) - 1
        for i, layer in enumerate(self.projector):
            h = layer(h)
            if i < last:
                h = torch.relu(h)
        return h

    def forward(self, x: Tensor) -> Tensor:
        return self.projector_apply(self.backbone_apply(x))

    embed = forward


def init_ssl_model(
    cfg: SSLModelConfig, *, seed: int = 0, device=None
) -> SSLModel:
    """Random weights from a seeded ``torch.Generator``, scaled as the
    reference scales them: w ~ N(0, 1) / sqrt(fan_in), b = 0."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    model = SSLModel(cfg)
    with torch.no_grad():
        for layer in list(model.backbone) + list(model.projector):
            fan_in = layer.in_features
            w = torch.randn(layer.out_features, fan_in, generator=gen) / float(np.sqrt(fan_in))
            layer.weight.copy_(w)
            layer.bias.zero_()
    return model.to(device)


def params_from_jax(
    tree: Mapping[str, List[Mapping[str, np.ndarray]]],
    cfg: Optional[SSLModelConfig] = None,
    *,
    device=None,
) -> SSLModel:
    """An ``SSLModel`` holding the reference's parameter tree.

    ``tree``: {"backbone": [{"w": (in, out), "b": (out,)}, ...],
    "projector": [...]} of array-likes (numpy, or anything ``np.asarray``
    takes).  ``cfg`` defaults to the widths the tree implies.
    """
    def dims(layers) -> Tuple[int, ...]:
        return tuple(int(np.asarray(layer["w"]).shape[1]) for layer in layers)

    if cfg is None:
        cfg = SSLModelConfig(
            input_dim=int(np.asarray(tree["backbone"][0]["w"]).shape[0]),
            backbone_widths=dims(tree["backbone"]),
            projector_widths=dims(tree["projector"]),
        )
    model = SSLModel(cfg)
    state: Dict[str, Tensor] = {}
    for part in ("backbone", "projector"):
        if len(tree[part]) != len(getattr(model, part)):
            raise ValueError(f"{part}: tree has {len(tree[part])} layers, config {len(getattr(model, part))}")
        for i, layer in enumerate(tree[part]):
            w = np.asarray(layer["w"], np.float32)
            state[f"{part}.{i}.weight"] = torch.tensor(w.T)  # copies: (out, in)
            state[f"{part}.{i}.bias"] = torch.tensor(np.asarray(layer["b"], np.float32))
    model.load_state_dict(state)
    return model.to(device)


def make_ssl_train_step(
    model_cfg: SSLModelConfig,
    loss_cfg: DecorrConfig,
    optimizer: Optimizer,
    schedule: Callable[[int], float],
    clip_norm: Optional[float] = None,
    perm_fn: Optional[Callable[[int], Tensor]] = None,
    *,
    impl: Optional[str] = None,
):
    """Returns ``(train_step, loss_fn)``.

    ``train_step(state, batch) -> (state, metrics)``: ``batch`` is
    {"view1", "view2"} of (n, input_dim) tensors on the model's device.  The
    step's feature permutation is ``perm_fn(step)`` (default
    ``permutation_for_step(state.seed, step, d)``; a comparison with the
    reference hands in the reference's own indices).  The gradients are
    complete before the optimizer touches a parameter, so a fault raised
    during the forward or backward pass leaves the state as it was and
    ``with_retries`` can replay the step.  Metrics stay device tensors (no
    host sync); ``lr`` is the host float the schedule gave.

    ``loss_fn(model, batch, perm) -> (loss, metrics)``.  ``impl`` overrides
    the regularizer route (``"plain"`` on a CUDA device is how the smoke
    holds the kernel route against torch.fft).
    """
    d = int(model_cfg.projector_widths[-1])
    wants_perm = loss_cfg.permute and loss_cfg.reg == "sum"

    def loss_fn(model: nn.Module, batch: Mapping[str, Tensor], perm: Optional[Tensor]):
        z1 = model(batch["view1"])
        z2 = model(batch["view2"])
        return ssl_loss(z1, z2, loss_cfg, perm, impl=impl)

    def train_step(state: TrainState, batch: Mapping[str, Tensor]) -> Tuple[TrainState, Dict]:
        if not isinstance(state.opt_state, optimizer.cls):
            raise TypeError(f"state holds a {type(state.opt_state).__name__}, the step was made for {optimizer.name}")
        perm = None
        if wants_perm:
            device = batch["view1"].device
            perm = perm_fn(state.step) if perm_fn is not None else permutation_for_step(state.seed, state.step, d)
            if device.type == "cuda" and not perm.is_cuda:
                # a pageable host->device copy would stall the host on the stream
                perm = perm.pin_memory().to(device, non_blocking=True)
            perm = perm.to(device)
        params = [p for p in state.model.parameters() if p.requires_grad]
        loss, metrics = loss_fn(state.model, batch, perm)
        grads = torch.autograd.grad(loss, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if clip_norm is not None:
            grads, metrics["grad_norm"] = clip_by_global_norm(grads, clip_norm)
        lr = schedule(state.step)
        metrics["lr"] = lr
        # every gradient is complete: only now does anything change in place
        for p, g in zip(params, grads):
            p.grad = g
        state.opt_state.step(lr)
        for p in params:
            p.grad = None
        state.step += 1
        return state, metrics

    return train_step, loss_fn
