"""The paper's SSL model — MLP backbone + projector — forward only (port of
the model part of ``repro/train/ssl.py``; the train step is the next slice).

``SSLModel`` is an ``nn.Module`` with ``backbone`` and ``projector``
``nn.Linear`` stacks: ReLU after every backbone layer and after every
projector layer but the last.  ``params_from_jax`` loads the reference's
``{"backbone": [{"w", "b"}...], "projector": [...]}`` parameter tree (as
numpy arrays) into it, so the port and the reference compute the same
embeddings.  The reference stores ``w`` as (in, out); ``nn.Linear`` keeps
(out, in).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

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
