"""Input specs and the parameter / optimizer sharding rules of every
(architecture x input shape) dry-run cell (port of ``repro/launch/specs.py``).

Nothing here allocates memory: parameters, optimizer state, caches and
batches are fake tensors (``FakeTensorMode``: shape, dtype and device, no
storage behind them), made by the same builders a real run calls
(``init_params`` and the optimizer's ``init`` under the fake mode), each
carrying the ``NamedSharding`` the reference's GSPMD layout gives it as its
``.sharding`` attribute — where the reference has ``jax.ShapeDtypeStruct``s.
Every spec of one process comes from one fake mode (``fake_mode()``), so
``launch/hlo_cost.analyze`` takes them as they are.

The sharding rules are the reference's, on the port's parameter paths (the
tree's keys, e.g. ``("blocks", "pos0", "attn", "wq")``): "data" is the FSDP
axis, "model" the TP / EP axis.  ``parallel/fsdp_tp.place_train_state``
places a train state by them (the 2-D train step runs on the blocks), and
``place_params`` / ``place_caches`` place the serving steps' parameters and
KV caches (``cache_sharding``: the caches' rows over "model");
``launch/dryrun`` records what the layout holds beside what the port's
step holds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import ParamTree, cache_shardings_logical, init_caches, init_params
from repro_torch.parallel.sharding import NamedSharding, logical_to_spec, sharding_context

Tensor = torch.Tensor
Spec = Tuple[Any, ...]

_MODE: Optional[FakeTensorMode] = None


def fake_mode() -> FakeTensorMode:
    """The fake mode every spec of this process is made in."""
    global _MODE
    if _MODE is None:
        _MODE = FakeTensorMode(allow_non_fake_inputs=True)
    return _MODE


# ---------------------------------------------------------------------------
# Assigned input shapes (assignment block)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs whose decode cost is sub-quadratic in context => run long_500k
LONG_CONTEXT_ARCHS = ("rwkv6-3b", "jamba-v0.1-52b")


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_ARCHS:
        return False, (
            "skipped: full/global attention is quadratic in a 524k cache; "
            "run for SSM/hybrid archs only (DESIGN.md §5)"
        )
    return True, ""


# ---------------------------------------------------------------------------
# Parameter sharding rules (path-name based)
# ---------------------------------------------------------------------------

# stacked block leaves: name -> spec for (rep, *dims); non-stacked handled
# separately.  "data" = FSDP axis, "model" = TP/EP axis.
_BLOCK_RULES: Dict[str, Tuple] = {
    "wq": (None, "data", "model"),
    "wk": (None, "data", "model"),
    "wv": (None, "data", "model"),
    "wo": (None, "model", "data"),
    "bq": (None, "model"),
    "bk": (None, "model"),
    "bv": (None, "model"),
    "w_gate": (None, "data", "model"),
    "router": (None, "data", None),
    "in_proj": (None, "data", "model"),
    "conv_w": (None, None, "model"),
    "conv_b": (None, "model"),
    "x_proj": (None, "model", None),
    "dt_proj": (None, None, "model"),
    "dt_bias": (None, "model"),
    "a_log": (None, "model", None),
    "d_skip": (None, "model"),
    "out_proj": (None, "model", "data"),
    "w_r": (None, "data", "model"),
    "w_k": (None, "data", "model"),
    "w_v": (None, "data", "model"),
    "w_g": (None, "data", "model"),
    "w_o": (None, "model", "data"),
    "cmix_wk": (None, "data", "model"),
    "cmix_wv": (None, "model", "data"),
    "cmix_wr": (None, "data", "model"),
    "lora_a": (None, "data", None),
    "lora_b": (None, None, None, "data"),
    "decay_lora_a": (None, "data", None),
    "decay_lora_b": (None, None, "data"),
}

# rank-dependent (dense MLP (rep,d,ff) vs MoE experts (rep,E,d,ff))
_W_IN_LIKE = {"w_in"}
_W_OUT_LIKE = {"w_out"}


def _leaf_name(path) -> str:
    """The last key of a tree path (a tuple of keys, or a dotted /
    slashed string: ``state_dict`` names)."""
    if isinstance(path, str):
        path = path.replace("/", ".").split(".")
    return str(path[-1]) if len(path) else ""


def param_spec(path, leaf) -> Spec:
    name = _leaf_name(path)
    ndim = len(leaf.shape)
    if name == "embed":
        if ndim == 3:  # (n_q, V, d) audio
            return (None, "model", "data")
        return ("model", "data")
    if name in ("lm_head", "heads"):
        return ("data", "model")
    if name in _W_IN_LIKE:
        return (None, "model", "data", None) if ndim == 4 else (None, "data", "model")
    if name in _W_OUT_LIKE:
        return (None, "model", None, "data") if ndim == 4 else (None, "model", "data")
    if name == "w_gate" and ndim == 4:
        return (None, "model", "data", None)
    rule = _BLOCK_RULES.get(name)
    if rule is not None and len(rule) == ndim:
        return tuple(rule)
    return ()  # norms, scalars, small adapters: replicated


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a ``DeviceMesh`` (or of anything with a ``shape``
    dict and ``axis_names``, the reference tests' stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(s) for n, s in zip(names, mesh.shape)}
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _divisible(shape, spec: Spec, mesh) -> bool:
    sizes = mesh_sizes(mesh)
    parts = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, part in zip(shape, parts):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        n = 1
        for a in axes:
            n *= sizes[a]
        if dim % n != 0:
            return False
    return True


def param_sharding(path, leaf, mesh) -> NamedSharding:
    spec = param_spec(path, leaf)
    if not _divisible(leaf.shape, spec, mesh):
        spec = ()
    return NamedSharding(mesh, spec)


def local_shape(shape: Sequence[int], sharding: NamedSharding) -> Tuple[int, ...]:
    """The block of a ``shape`` tensor one rank holds under ``sharding``."""
    sizes = mesh_sizes(sharding.mesh)
    out = list(shape)
    for dim, part in enumerate(sharding.spec):
        if part is None:
            continue
        for a in (part if isinstance(part, tuple) else (part,)):
            out[dim] //= sizes[a]
    return tuple(out)


def _placed(t: Tensor, sharding: NamedSharding) -> Tensor:
    t.sharding = sharding
    return t


def _map_tree(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def params_spec_tree(cfg: ArchConfig, mesh, device="cpu") -> Dict[str, Any]:
    """The parameter tree of fake tensors on ``device`` (``init_params``
    under the fake mode), each leaf carrying its ``param_sharding``."""
    with fake_mode():
        tree = init_params(cfg, device=device)
    return _map_tree(tree, lambda p, t: _placed(t, param_sharding(p, t, mesh)))


def param_tree_module(params_specs, mesh) -> ParamTree:
    """A ``ParamTree`` over the spec tree's leaves (fake parameters; each
    keeps its sharding): the model a train state holds."""
    with fake_mode():
        model = ParamTree(params_specs)
    for name, p in model.named_parameters():
        _placed(p, param_sharding(name, p, mesh))
    return model


def opt_state_spec_tree(opt_init, params_specs, mesh) -> torch.optim.Optimizer:
    """The optimizer ``opt_init`` builds over the fake parameters (a
    ``ParamTree``, or a spec tree made into one); its moments inherit
    their parameter's sharding (the state of a parameter mirrors its path)."""
    model = params_specs if isinstance(params_specs, nn.Module) else param_tree_module(params_specs, mesh)
    with fake_mode():
        opt = opt_init(model.parameters())
    names = {id(p): n for n, p in model.named_parameters()}
    for p, state in opt.state.items():
        for v in state.values():
            if isinstance(v, Tensor):
                _placed(v, param_sharding(names[id(p)], v, mesh))
    return opt


# ---------------------------------------------------------------------------
# Batch / cache input specs
# ---------------------------------------------------------------------------


def _batch_axes(mesh) -> Tuple[str, ...]:
    names = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _batch_spec(mesh, batch: int, extra: Tuple = ()) -> NamedSharding:
    axes = _batch_axes(mesh)
    sizes = mesh_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    first = axes if (batch % n == 0 and batch >= n) else None
    return NamedSharding(mesh, (first, *extra))


def _sds(shape, dtype, sharding: NamedSharding, device) -> Tensor:
    with fake_mode():
        t = torch.empty(shape, dtype=dtype, device=device)
    return _placed(t, sharding)


def batch_specs(cfg: ArchConfig, shape: ShapeSpec, mesh, device="cpu") -> Dict[str, Any]:
    """Train-batch specs for this arch."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.frontend == "vision_stub":
        return {
            "embeds": _sds((b, s, cfg.d_model), torch.bfloat16, _batch_spec(mesh, b, (None, None)), device),
            "positions": _sds((3, b, s), torch.int32, NamedSharding(mesh, (None, _batch_axes(mesh) or None, None)),
                              device),
            "labels": _sds((b, s), torch.int32, _batch_spec(mesh, b, (None,)), device),
        }
    if cfg.frontend == "audio_codes":
        return {
            "tokens": _sds((b, s, cfg.n_codebooks), torch.int32, _batch_spec(mesh, b, (None, None)), device),
            "labels": _sds((b, s, cfg.n_codebooks), torch.int32, _batch_spec(mesh, b, (None, None)), device),
        }
    return {
        "tokens": _sds((b, s), torch.int32, _batch_spec(mesh, b, (None,)), device),
        "labels": _sds((b, s), torch.int32, _batch_spec(mesh, b, (None,)), device),
    }


def decode_token_specs(cfg: ArchConfig, batch: int, mesh, device="cpu") -> Dict[str, Any]:
    if cfg.frontend == "vision_stub":
        return {
            "embeds": _sds((batch, 1, cfg.d_model), torch.bfloat16, _batch_spec(mesh, batch, (None, None)), device),
            "positions": _sds((3, batch, 1), torch.int32,
                              NamedSharding(mesh, (None, _batch_axes(mesh) or None, None)), device),
        }
    if cfg.frontend == "audio_codes":
        return {"tokens": _sds((batch, 1, cfg.n_codebooks), torch.int32, _batch_spec(mesh, batch, (None, None)),
                               device)}
    return {"tokens": _sds((batch, 1), torch.int32, _batch_spec(mesh, batch, (None,)), device)}


def cache_sharding(cfg: ArchConfig, path, shape, mesh) -> NamedSharding:
    """The placement of the decode-state leaf at ``path`` ((pattern
    position, leaf name)) of ``shape`` ((stack, batch, ...)): its logical
    axes (``cache_shardings_logical``; attention KV sequence-split over
    ``model``) on ``mesh``, the batch unsplit where it does not divide
    over the batch axes, and the whole leaf where the spec does not
    divide.  ``cache_specs`` and ``parallel/fsdp_tp.place_caches`` both
    place by it."""
    sizes = mesh_sizes(mesh)
    with sharding_context(mesh):
        axes = list(cache_shardings_logical(cfg).get(path[0], {}).get(path[-1], (None,) * len(shape)))
        # batch axis: only shard when divisible
        n = 1
        for a in _batch_axes(mesh):
            n *= sizes[a]
        batch = shape[1]
        if "batch" in axes and (batch % n != 0 or batch < n):
            axes[axes.index("batch")] = None
        spec = logical_to_spec(axes)
    if not _divisible(shape, spec, mesh):
        spec = ()
    return NamedSharding(mesh, spec)


def cache_specs(cfg: ArchConfig, batch: int, max_len: int, mesh, device="cpu"):
    """Decode-state specs; attention KV seq-sharded over model."""
    with fake_mode():
        caches = init_caches(cfg, batch, max_len, device=device)
    return _map_tree(caches, lambda path, t: _placed(t, cache_sharding(cfg, path, t.shape, mesh)))


def scalar_spec(mesh, dtype=torch.int32, device="cpu") -> Tensor:
    return _sds((), dtype, NamedSharding(mesh, ()), device)


def rng_spec(mesh, device="cpu") -> Tensor:
    return _sds((2,), torch.uint32, NamedSharding(mesh, ()), device)
