"""Logical-axis sharding rules (port of ``repro/parallel/sharding.py``).

Models name the axes of their tensors *logically*, e.g.
``("batch", "feature")``; the launcher installs a rule table mapping
logical axes to mesh dimensions.  A ``DeviceMesh`` from
``torch.distributed.device_mesh`` plays the part of the JAX ``Mesh``: its
``mesh_dim_names`` are the mesh axes, and an axis name resolves to the
process group of that mesh dimension (``mesh.get_group(name)``).  Outside
an installed context no axis is bound, so single-process runs never touch
process-group state.

Default rule table (the reference's, verbatim):
  batch    -> ("pod", "data")   activations data-parallel
  embed    -> None              residual stream replicated
  heads    -> "model"           attention TP
  kv_heads -> None              small; replicated within a model row
  ff       -> "model"           MLP TP
  feature  -> "model"           TP projector output (decorr engine 'tp' mode)
  experts  -> "model"           expert parallelism
  vocab    -> "model"           embedding / LM-head TP
  kv_seq   -> "model"           decode KV caches seq-sharded
  fsdp     -> "data"            parameter / optimizer-state sharding

A spec is a tuple with one entry per tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of names (the dimension split
over their product, the first name major).  ``named_sharding(axes)`` gives
the ``NamedSharding`` of a spec on the current mesh: ``local(x)`` cuts this
rank's block out of a full tensor, ``gather(x)`` puts the full tensor back
together from every rank's block.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Tensor = torch.Tensor
SpecEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[SpecEntry, ...]
AxisName = Union[str, Sequence[str]]

_STATE = threading.local()

DEFAULT_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": ("model",),
    "kv_heads": None,
    "head_dim": None,
    "ff": ("model",),
    "feature": ("model",),  # TP projector output (decorr engine 'tp' mode)
    "experts": ("model",),
    "vocab": ("model",),
    "kv_seq": ("model",),
    "fsdp": ("data",),
    "stack": None,  # stacked-layer leading dim
}


def current_mesh():
    """The installed ``DeviceMesh``, or None."""
    return getattr(_STATE, "mesh", None)


def current_rules() -> Dict[str, Optional[Tuple[str, ...]]]:
    """The installed rule table (``DEFAULT_RULES`` outside a context)."""
    return getattr(_STATE, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def sharding_context(mesh, rules: Optional[Dict] = None):
    """Install ``mesh`` + logical rules (merged over ``DEFAULT_RULES``)."""
    prev_mesh = getattr(_STATE, "mesh", None)
    prev_rules = getattr(_STATE, "rules", None)
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _STATE.mesh = mesh
    _STATE.rules = merged
    try:
        yield
    finally:
        _STATE.mesh = prev_mesh
        if prev_rules is None:
            if hasattr(_STATE, "rules"):
                del _STATE.rules
        else:
            _STATE.rules = prev_rules


@contextlib.contextmanager
def data_parallel(axis: Optional[AxisName]):
    """Mark the enclosed forward as one rank's block of a data-parallel
    batch sharded over mesh axis ``axis`` (or a tuple of axes, the first
    major): a batch statistic that is not a
    mean of per-row terms (the MoE router's token fractions and its capacity
    positions) is then taken over the whole batch, as GSPMD takes it over
    the reference's global array.  ``None`` marks nothing."""
    prev = getattr(_STATE, "dp_axis", None)
    _STATE.dp_axis = axis
    try:
        yield
    finally:
        _STATE.dp_axis = prev


def data_parallel_axis() -> Optional[AxisName]:
    """The axis ``data_parallel`` installed, or None."""
    return getattr(_STATE, "dp_axis", None)


def current_state():
    """What this thread has installed: (mesh, rules, data-parallel axis)."""
    return current_mesh(), getattr(_STATE, "rules", None), data_parallel_axis()


@contextlib.contextmanager
def installed(state):
    """Install a ``current_state()`` again: a forward pass recomputed in the
    backward pass (``models.transformer``'s remat; the backward may run on
    another thread) must see the layout its first run saw."""
    mesh, rules, axis = state
    with sharding_context(mesh, rules) if mesh is not None else contextlib.nullcontext():
        with data_parallel(axis):
            yield


def axis_index(axis: AxisName) -> int:
    """This rank's index along mesh axis ``axis`` of the current mesh; for a
    tuple of axes, its row-major index over them (the first axis major, as
    a spec entry's blocks are ordered)."""
    axis_groups(axis)  # raises on an unbound axis
    return _block(current_mesh(), axis)[0]


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()


def logical_to_spec(axes: Sequence[Optional[str]]) -> Spec:
    """Map logical axis names to a spec under the current rules, dropping
    mesh axes that the current mesh lacks (e.g. "pod" on a single-pod mesh)
    or that an earlier dimension already uses."""
    mesh_axes = set(_axis_names(current_mesh()))
    rules = current_rules()
    spec: List[SpecEntry] = []
    used: set = set()
    for ax in axes:
        mapped = rules.get(ax) if ax is not None else None
        if mapped is None:
            spec.append(None)
            continue
        keep = tuple(m for m in mapped if m in mesh_axes and m not in used)
        used.update(keep)
        spec.append(None if not keep else keep[0] if len(keep) == 1 else keep)
    return tuple(spec)


def shard(x: Tensor, axes: Sequence[Optional[str]]) -> Tensor:
    """``x`` unchanged.  In JAX this is ``with_sharding_constraint``, a hint
    to the compiler about a value's layout that never changes the value;
    eager PyTorch has no compiler to hint, so the annotation is kept for the
    call sites' sake and does nothing."""
    return x


def _names(axis: AxisName) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_groups(axis: AxisName) -> List[dist.ProcessGroup]:
    """The process group of each mesh axis in ``axis`` (a name or names) on
    the current mesh.  Raises when no mesh is installed or it lacks the
    axis: a collective over an unbound axis has no meaning."""
    mesh = current_mesh()
    names = _axis_names(mesh)
    for name in _names(axis):
        if name not in names:
            raise ValueError(
                f"mesh axis {name!r} is not bound: the current mesh has axes {names} "
                "(install one with repro_torch.parallel.sharding.sharding_context(mesh))")
    return [mesh.get_group(name) for name in _names(axis)]


def axis_size(axis: AxisName) -> int:
    """Product of the sizes of the mesh axes in ``axis`` (a static int)."""
    mesh = current_mesh()
    axis_groups(axis)  # raises on an unbound axis
    names = _axis_names(mesh)
    n = 1
    for name in _names(axis):
        n *= int(mesh.shape[names.index(name)])
    return n


def _block(mesh, entry: SpecEntry) -> Tuple[int, int]:
    """(this rank's block index, number of blocks) along a dimension whose
    spec entry is ``entry``: row-major over its mesh axes."""
    idx, n = 0, 1
    names = _axis_names(mesh)
    for name in _names(entry):
        size = int(mesh.shape[names.index(name)])
        idx = idx * size + int(mesh.get_local_rank(mesh_dim=name))
        n *= size
    return idx, n


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: which block of a full tensor each rank holds."""

    mesh: object
    spec: Spec

    def local(self, x: Tensor) -> Tensor:
        """This rank's block of the full tensor ``x`` (a contiguous copy)."""
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            idx, n = _block(self.mesh, entry)
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split into {n} blocks")
            size = x.shape[dim] // n
            x = x.narrow(dim, idx * size, size)
        return x.contiguous()

    def gather(self, x: Tensor) -> Tensor:
        """The full tensor from every rank's block ``x`` (all-gathers over
        the sharded dimensions' axes, the minor axis first)."""
        x = x.contiguous()
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            for name in reversed(_names(entry)):
                group = self.mesh.get_group(name)
                parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, x, group=group)
                x = torch.cat(parts, dim=dim)
        return x


def named_sharding(axes: Sequence[Optional[str]]) -> Optional[NamedSharding]:
    """The ``NamedSharding`` of logical ``axes`` on the current mesh, or
    None outside a context."""
    mesh = current_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, logical_to_spec(axes))
