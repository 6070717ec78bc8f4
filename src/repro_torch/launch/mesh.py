"""Device meshes (port of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the initialised default process group, one rank a device.  These are
FUNCTIONS, never module-level constants: importing this module touches no
process-group state.  Each raises unless a process group of exactly the
mesh's size is initialised (``torch.distributed.init_process_group``, or
``torchrun``), because a mesh is a layout of ranks that already exist.
The mesh's device type follows the group's backend: NCCL meshes are
``cuda``, gloo meshes ``cpu``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _make_mesh(shape: Sequence[int], axes: Sequence[str]) -> DeviceMesh:
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {tuple(shape)} mesh needs an initialised process group of {n} ranks; none is")
    if dist.get_world_size() != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the process group has {dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(data 16, model 16), or (pod 2, data 16, model 16) with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes)


def make_mesh_for_devices(n_devices: int, model_parallel: int = 1) -> DeviceMesh:
    """The (data, model) = (n / mp, mp) mesh over ``n_devices`` ranks."""
    if model_parallel < 1 or n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices do not split into model-parallel groups of {model_parallel}")
    return _make_mesh((n_devices // model_parallel, model_parallel), ("data", "model"))
