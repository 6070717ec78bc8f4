"""The paper's SSL setting: MLP backbone + projector trained with Barlow
Twins / VICReg-style losses (port of ``repro/train/ssl.py``).

``SSLModel`` is an ``nn.Module`` with ``backbone`` and ``projector``
``nn.Linear`` stacks: ReLU after every backbone layer and after every
projector layer but the last.  ``params_from_jax`` loads the reference's
``{"backbone": [{"w", "b"}...], "projector": [...]}`` parameter tree (as
numpy arrays) into it, so the port and the reference compute the same
embeddings.  The reference stores ``w`` as (in, out); ``nn.Linear`` keeps
(out, in).

``make_ssl_train_step`` is the reference's step: loss and gradients by
autograd (through the kernels' own vjps on a CUDA device), optional global
norm clipping, lr = schedule(step), then the optimizer update.

``make_sharded_ssl_train_step`` is the mesh-aware variant: every rank of a
``DeviceMesh`` runs the step on its slice of the batch (``shard_ssl_batch``),
data-parallel over the ``data`` axis and — in the engine's ``tp`` mode —
with the projector OUTPUT layer feature-sharded over the ``model`` axis
(``ssl_param_specs``, ``create_sharded_ssl_state``), so each rank only materializes
(n_local, d / P) projections and the engine's all-to-all does the rest.
Its gradients follow JAX's rule for differentiating through ``shard_map``
(``decorr/modes.py``): each rank's backward gives its share, and a
parameter's gradient is summed over the mesh axes it is replicated on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.core.losses import ssl_loss
from repro_torch.core.permutation import permutation_for_step
from repro_torch.decorr.config import DecorrConfig
from repro_torch.optim import compression as comp
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm
from repro_torch.parallel import sharding as shd
from repro_torch.train.train_state import ShardedTrainState, TrainState

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
        perm = _step_perm(state, batch["view1"].device, d, perm_fn) if wants_perm else None
        loss, metrics = loss_fn(state.model, batch, perm)
        grads = torch.autograd.grad(loss, list(state.model.parameters()))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return _update(state, grads, metrics, optimizer, schedule, clip_norm), metrics

    return train_step, loss_fn


def _step_perm(state: TrainState, device, d: int, perm_fn) -> Tensor:
    """The step's permutation on ``device``: ``perm_fn(step)``, or
    ``permutation_for_step(state.seed, step, d)``."""
    perm = perm_fn(state.step) if perm_fn is not None else permutation_for_step(state.seed, state.step, d)
    if device.type == "cuda" and not perm.is_cuda:
        # a pageable host->device copy would stall the host on the stream
        perm = perm.pin_memory().to(device, non_blocking=True)
    return perm.to(device)


def _update(state: TrainState, grads, metrics: Dict, optimizer: Optimizer, schedule, clip_norm) -> TrainState:
    """Clip (``grad_norm``), lr = schedule(step) (``lr``), the optimizer's
    update from ``grads``, step + 1.  Every gradient is complete when this
    runs: only now does anything change in place."""
    if clip_norm is not None:
        params = list(state.model.parameters())
        grads, metrics["grad_norm"] = clip_by_global_norm(grads, clip_norm, params)
    lr = schedule(state.step)
    metrics["lr"] = lr
    state.opt_state.step(lr, grads)
    state.step += 1
    return state


# ---------------------------------------------------------------------------
# Mesh-aware variant: every rank steps on its batch slice
# ---------------------------------------------------------------------------


def ssl_param_specs(model_cfg: SSLModelConfig, loss_cfg: DecorrConfig, mesh) -> Dict[str, shd.Spec]:
    """The spec of every ``SSLModel`` parameter, by ``state_dict`` name, in
    torch's layout (an ``nn.Linear`` weight is (out, in)).

    Everything is replicated (``()``) except — in ``tp`` mode — the
    projector OUTPUT layer, whose weight rows / bias entries are
    feature-sharded over the logical "feature" axis (-> the "model" mesh
    axis by ``parallel/sharding.py``'s rules).
    """
    specs: Dict[str, shd.Spec] = {}
    for part, widths in (("backbone", model_cfg.backbone_widths), ("projector", model_cfg.projector_widths)):
        for i in range(len(widths)):
            specs[f"{part}.{i}.weight"] = specs[f"{part}.{i}.bias"] = ()
    if loss_cfg.distributed == "tp":
        last = len(model_cfg.projector_widths) - 1
        with shd.sharding_context(mesh):
            specs[f"projector.{last}.weight"] = shd.logical_to_spec(("feature", None))
            specs[f"projector.{last}.bias"] = shd.logical_to_spec(("feature",))
    return specs


def _shardings(specs: Dict[str, shd.Spec], mesh) -> Dict[str, shd.NamedSharding]:
    return {name: shd.NamedSharding(mesh, spec) for name, spec in specs.items() if any(spec)}


def create_sharded_ssl_state(model: SSLModel, optimizer: Optimizer, specs, mesh, seed: int = 0) -> ShardedTrainState:
    """Step 0 of a sharded run from the FULL ``model`` (the same on every
    rank, e.g. ``params_from_jax`` of a reference tree): this rank's model,
    each parameter cut to its block under ``specs`` on ``mesh`` (a ``tp``
    output layer holds d / P rows), and a fresh optimizer over it.  A
    sharded parameter carries the process groups it is split over as
    ``shard_groups``, for LARS's and the clip's norms; the state's
    ``state_dict`` is the full tree an unsharded run writes."""
    shardings = _shardings(specs, mesh)
    state = {name: (shardings[name].local(x) if name in shardings else x.clone())
             for name, x in model.state_dict().items()}
    widths = tuple(model.cfg.projector_widths[:-1]) + (int(state[f"projector.{len(model.projector) - 1}.bias"].numel()),)
    local = SSLModel(dataclasses.replace(model.cfg, projector_widths=widths)).to(next(model.parameters()).device)
    local.load_state_dict(state)
    params = dict(local.named_parameters())
    with shd.sharding_context(mesh):
        for name, sharding in shardings.items():
            # a split over a group of one is no split: the whole tensor is here
            groups = [g for entry in sharding.spec if entry for g in shd.axis_groups(entry)]
            params[name].shard_groups = tuple(g for g in groups if dist.get_world_size(g) > 1)
    return ShardedTrainState(step=0, model=local, opt_state=optimizer.init(local.parameters()), seed=seed,
                             shardings=shardings)


def make_sharded_ssl_train_step(
    model_cfg: SSLModelConfig,
    loss_cfg: DecorrConfig,
    optimizer: Optimizer,
    schedule: Callable[[int], float],
    mesh,
    clip_norm: Optional[float] = None,
    data_axis: str = "data",
    model_axis: str = "model",
    perm_fn: Optional[Callable[[int], Tensor]] = None,
    *,
    impl: Optional[str] = None,
):
    """``make_ssl_train_step`` on every rank of ``mesh`` (a ``DeviceMesh``).

    The batch is data-parallel over ``data_axis`` in every mode: each rank
    steps on its slice (``shard_ssl_batch``).  The loss semantics follow
    ``loss_cfg.distributed``:

      * ``local``  — each data shard computes the paper-faithful shard-local
        loss; gradients (and the reported loss and metrics) are the DDP mean
        over the data shards;
      * ``global`` — the engine all-reduces the O(d) accumulators, so loss
        and gradients equal one device's on the full concatenated batch;
      * ``tp``     — the projector output layer (and hence z) is also
        feature-sharded over ``model_axis`` (``state`` from
        ``create_sharded_ssl_state``); the engine's all-to-all and all-reduces
        reassemble the exact unsharded loss.

    The permutation is ``perm_fn(step)`` (default
    ``permutation_for_step(state.seed, step, d)``, d the full width): the
    same indices on every rank.  Returns ``(train_step, loss_and_grads)``:
    ``loss_and_grads(model, batch, perm) -> (loss, metrics, grads)``, the
    gradients reduced over the ranks, loss and metrics detached;
    ``train_step(state, batch) -> (state, metrics)`` as
    ``make_ssl_train_step``'s, every gradient complete and reduced before
    the optimizer touches a parameter (clip and LARS on the whole tree's
    norms).
    """
    names = tuple(mesh.mesh_dim_names or ())
    if data_axis not in names:
        raise ValueError(f"mesh {names} has no data axis {data_axis!r}")
    tp = loss_cfg.distributed == "tp"
    if tp:
        if model_axis not in names:
            raise ValueError(f"mesh {names} has no model axis {model_axis!r}")
        d_out = model_cfg.projector_widths[-1]
        p_model = int(mesh.shape[names.index(model_axis)])
        if d_out % p_model:
            raise ValueError(f"projector width {d_out} not divisible by model={p_model}")

    cfg = loss_cfg
    if cfg.distributed in ("global", "tp"):
        cfg = dataclasses.replace(cfg, axis_name=data_axis)
    if tp:
        cfg = dataclasses.replace(cfg, model_axis=model_axis)
    mode = cfg.distributed
    sharded = set(_shardings(ssl_param_specs(model_cfg, loss_cfg, mesh), mesh))
    d = int(model_cfg.projector_widths[-1])
    wants_perm = loss_cfg.permute and loss_cfg.reg == "sum"

    def loss_and_grads(model: nn.Module, batch: Mapping[str, Tensor], perm: Optional[Tensor]):
        named = list(model.named_parameters())
        with shd.sharding_context(mesh):
            loss, metrics = ssl_loss(model(batch["view1"]), model(batch["view2"]), cfg, perm, impl=impl)
            grads = list(torch.autograd.grad(loss, [p for _, p in named]))
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
            if mode == "local":
                # the DDP objective: the mean over the shard-local losses
                p_data = shd.axis_size(data_axis)
                vals = comp.psum([torch.stack([loss, *metrics.values()])], data_axis)[0] / p_data
                loss, metrics = vals[0], dict(zip(metrics, vals[1:]))
                grads = [g / p_data for g in _sum_grads(grads, [(data_axis,)] * len(grads))]
            else:
                # a parameter's gradient sums its shares over the axes it is
                # replicated on: the tp output layer over the data axis only
                axes = [(data_axis, model_axis) if tp and name not in sharded else (data_axis,)
                        for name, _ in named]
                grads = _sum_grads(grads, axes)
        return loss, metrics, grads

    def train_step(state: TrainState, batch: Mapping[str, Tensor]) -> Tuple[TrainState, Dict]:
        if not isinstance(state.opt_state, optimizer.cls):
            raise TypeError(f"state holds a {type(state.opt_state).__name__}, the step was made for {optimizer.name}")
        perm = _step_perm(state, batch["view1"].device, d, perm_fn) if wants_perm else None
        _, metrics, grads = loss_and_grads(state.model, batch, perm)
        return _update(state, grads, metrics, optimizer, schedule, clip_norm), metrics

    return train_step, loss_and_grads


def _sum_grads(grads: List[Tensor], axes: List[Tuple[str, ...]]) -> List[Tensor]:
    """Each gradient summed over its axes: one all-reduce for the gradients
    that share a set of axes."""
    out = list(grads)
    for key in dict.fromkeys(axes):
        idx = [i for i, a in enumerate(axes) if a == key]
        for i, g in zip(idx, comp.psum([grads[i] for i in idx], key)):
            out[i] = g
    return out


def shard_ssl_batch(batch: Mapping[str, Tensor], mesh) -> Dict[str, Tensor]:
    """This rank's slice of a full {view1, view2} batch: data-parallel rows
    by the logical "batch" axis."""
    with shd.sharding_context(mesh):
        sharding = shd.named_sharding(("batch", None))
    return {k: sharding.local(v) for k, v in batch.items()}
