"""Elastic re-mesh: restore a checkpoint onto a *different* rank count /
mesh shape (port of ``repro/ft/elastic.py``).

The port's checkpoints hold the full tree whatever mesh wrote them
(``train/train_state.ShardedTrainState`` gathers its shards before a save),
so the mesh geometry is a restore-time decision: ``reshard_to_mesh`` places
each leaf on the new mesh by ``spec_fn(path, leaf)``, this rank keeping its
block (``NamedSharding.local``).  A spec that does not divide its leaf on
the new mesh falls back to replication for that leaf, as the reference's
``_divisible`` rule does.  The default spec replicates everything.

A spec is the port's (``parallel/sharding.py``): one entry per dimension,
``None``, a mesh axis name or a tuple of names; a spec shorter than the
leaf's rank leaves the trailing dimensions whole.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import restore_checkpoint
from repro_torch.parallel.sharding import NamedSharding, Spec


def _divisible(shape, spec: Optional[Spec], mesh) -> bool:
    names = tuple(mesh.mesh_dim_names or ())
    for dim, part in zip(shape, tuple(spec or ())):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        n = math.prod(int(mesh.shape[names.index(a)]) for a in axes)
        if dim % n != 0:
            return False
    return True


def _place(leaf, spec: Optional[Spec], mesh):
    if isinstance(leaf, np.ndarray):
        leaf = torch.from_numpy(leaf)
    if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0 or not spec or not _divisible(leaf.shape, spec, mesh):
        return leaf.clone() if isinstance(leaf, torch.Tensor) else leaf
    spec = tuple(spec)[: leaf.dim()]
    return NamedSharding(mesh, spec + (None,) * (leaf.dim() - len(spec))).local(leaf)


def _map_with_path(fn, tree, path: Tuple = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def reshard_to_mesh(state: Any, mesh, spec_fn: Callable[[tuple, Any], Optional[Spec]]):
    """Every leaf of ``state`` (a tree of dicts / lists of tensors or
    arrays) cut to this rank's block under ``spec_fn(path, leaf)`` on
    ``mesh``; a spec of None, or one that does not divide the leaf,
    replicates it.  Leaves that are not arrays pass through."""
    return _map_with_path(lambda path, leaf: _place(leaf, spec_fn(path, leaf), mesh), state)


def elastic_restore(
    ckpt_dir: str,
    step: int,
    template: Any,
    new_mesh,
    spec_fn: Optional[Callable] = None,
):
    """Restore a checkpoint written under any earlier mesh onto
    ``new_mesh`` (default spec: everything replicated)."""
    host_state = restore_checkpoint(ckpt_dir, step, template)
    if spec_fn is None:
        spec_fn = lambda path, leaf: None  # noqa: E731
    return reshard_to_mesh(host_state, new_mesh, spec_fn)
