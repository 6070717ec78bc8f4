"""Gradient compression for the data-parallel all-reduce (port of
``repro/optim/compression.py``).

Two schemes, used by ``train/step.make_compressed_dp_step`` where the
gradient reduction is explicit (``psum`` is the uncompressed f32 one):

* ``bf16_psum``     — cast to bf16 before the all-reduce (half the bytes);
                      unbiased for the mean at our batch sizes.
* ``int8_psum_ef``  — per-leaf int8 quantization with error feedback (the
                      1-bit Adam lineage): the quantization residual is
                      carried to the next step, so the compressed SGD
                      trajectory tracks the uncompressed one.

Gradients are a list, tuple or dict (nested freely) of tensors; axis names
resolve through the mesh installed with ``parallel.sharding.sharding_context``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.parallel.sharding import AxisName, axis_groups

Tensor = torch.Tensor
Tree = Any


def _flatten(tree: Tree) -> Tuple[List[Tensor], Callable[[List[Tensor]], Tree]]:
    """(leaves in a fixed order, rebuild(leaves) -> a tree of the same shape)."""
    leaves, spec = tree_flatten(tree)
    return leaves, lambda new: tree_unflatten(list(new), spec)


def _reduce_(x: Tensor, axis_name: AxisName, op=dist.ReduceOp.SUM) -> Tensor:
    for group in axis_groups(axis_name):
        dist.all_reduce(x, op=op, group=group)
    return x


def _sum_leaves(grads: Tree, axis_name: AxisName, dtype: torch.dtype) -> Tree:
    """Each leaf summed over ``axis_name`` in ``dtype`` (one collective for
    all leaves), returned in f32."""
    leaves, rebuild = _flatten(grads)
    if not leaves:
        return grads
    flat = _reduce_(torch.cat([g.to(dtype).reshape(-1) for g in leaves]), axis_name).float()
    parts = torch.split(flat, [g.numel() for g in leaves])
    return rebuild([x.reshape(g.shape) for x, g in zip(parts, leaves)])


def psum(grads: Tree, axis_name: AxisName) -> Tree:
    """The uncompressed reduction: each leaf's f32 sum over ``axis_name``."""
    return _sum_leaves(grads, axis_name, torch.float32)


def bf16_psum(grads: Tree, axis_name: AxisName) -> Tree:
    """Each leaf's sum over ``axis_name``, all-reduced in bf16, in f32."""
    return _sum_leaves(grads, axis_name, torch.bfloat16)


def _quantize_int8(x: Tensor, scale: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """(round-half-to-even(x / scale) clipped to [-127, 127] as int8, scale);
    ``scale`` defaults to max |x| / 127 + 1e-12."""
    if scale is None:
        scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def int8_psum_ef(grads: Tree, errors: Tree, axis_name: AxisName) -> Tuple[Tree, Tree]:
    """Compressed all-reduce with error feedback.

    Every rank quantizes against a COMMON per-leaf scale (one MAX all-reduce
    of all leaves' maxima — negligible traffic), so the int32 sum of the
    quantized values is exact: sum_i q_i * s == (sum_i q_i) * s.  Each
    rank's quantization residual is carried in ``errors`` and added to the
    next step's gradient.  ``grads`` / ``errors``: matching trees.  Returns
    (the f32 sum over the axis, the new errors).
    """
    g_leaves, rebuild = _flatten(grads)
    e_leaves, _ = _flatten(errors)
    if len(g_leaves) != len(e_leaves):
        raise ValueError(f"{len(g_leaves)} gradient leaves against {len(e_leaves)} error leaves")
    if not g_leaves:
        return grads, errors
    g32 = [g.float() + e for g, e in zip(g_leaves, e_leaves)]
    maxima = _reduce_(torch.stack([torch.max(torch.abs(g)) for g in g32]), axis_name, dist.ReduceOp.MAX)
    scales = maxima / 127.0 + 1e-12
    qs = [_quantize_int8(g, s)[0] for g, s in zip(g32, scales)]
    new_e = [g - q.float() * s for g, q, s in zip(g32, qs, scales)]
    total = _reduce_(torch.cat([q.to(torch.int32).reshape(-1) for q in qs]), axis_name)
    parts = torch.split(total, [q.numel() for q in qs])
    summed = [t.float().reshape(q.shape) * s for t, q, s in zip(parts, qs, scales)]
    return rebuild(summed), rebuild(new_e)


def init_error_feedback(grads_template: Tree) -> Tree:
    """Zero f32 error buffers shaped like ``grads_template``'s leaves."""
    leaves, rebuild = _flatten(grads_template)
    return rebuild([torch.zeros(g.shape, dtype=torch.float32, device=g.device) for g in leaves])
