"""Distributed decorrelation primitives (port of ``repro/decorr/modes.py``).

Three modes for computing the decorrelation statistics across ranks:

``local``  (paper-faithful): every data shard computes the loss on its local
    batch slice; cross-rank traffic is only the usual gradient all-reduce.

``global`` (beyond-paper): the frequency accumulator
    ``G = sum_k conj(F a_k) o F b_k`` is an *additive* statistic of the batch,
    so one all-reduce of d/2+1 complex numbers turns the local regularizer
    into the exact global-batch regularizer.  The same holds for the
    per-feature moments and the diagonal statistics: everything the loss
    needs is O(d) and additive.

``tp``     (feature-sharded): when the projector output dimension d is
    tensor-parallel over the ``model`` axis, the FFT spans shards.  One
    all-to-all transposes batch <-> feature (each of the P model shards ends
    up with n/P full-length feature vectors), the FFTs run shard-local, and
    the accumulator is all-reduced.

Every function here runs on each rank of a mesh installed with
``parallel.sharding.sharding_context``; axis arguments are mesh axis names
(strings), resolved to process groups through that mesh, as JAX binds them
under ``shard_map``.

Gradients follow JAX's differentiation through ``shard_map``, so each
rank's backward of a replicated loss L gives dL / d(its own inputs):

  * ``psum_if`` (all-reduce SUM) passes its cotangent on unchanged: the
    cotangent of a replicated value reaches each rank's operand once;
  * ``pvary_if`` is the identity forward and an all-reduce backward.  JAX
    inserts it (``pvary``) wherever a value replicated over an axis meets a
    computation that varies over it, as an all-reduced moment does when it
    is subtracted from this rank's rows (``engine.standardize`` / ``center``):
    each rank's cotangent of that moment is then only its rows' share, and
    the sum over the axis is the whole;
  * the all-to-all's cotangent takes the reverse all-to-all.

A replicated parameter's full gradient is then the SUM of the ranks'
gradients over the axes it is replicated on
(``train/ssl.make_sharded_ssl_train_step``).  The mode *routing* lives in
``decorr/engine.py``; this module owns the collective algebra.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.core import regularizers as regs
from repro_torch.core import sumvec as sv
from repro_torch.kernels.grouped_sumvec import ops as gops
from repro_torch.parallel.sharding import AxisName, axis_groups, axis_size

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Collectives with JAX's transposes
# ---------------------------------------------------------------------------


def _all_reduce_(x: Tensor, groups: List[dist.ProcessGroup]) -> Tensor:
    """Sum ``x`` (contiguous: NCCL takes no other) in place over each group
    (complex as its f32 pairs)."""
    buf = torch.view_as_real(x) if x.is_complex() else x
    for group in groups:
        dist.all_reduce(buf, group=group)
    return x


class _Psum(torch.autograd.Function):
    """All-reduce SUM forward, identity backward (psum's transpose under
    ``shard_map``: the cotangent of the replicated sum reaches each rank's
    operand unchanged)."""

    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce_(x.clone(memory_format=torch.contiguous_format), groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    """Identity forward, all-reduce SUM backward (JAX's ``pvary``)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.groups), None


def _tiled_all_to_all(x: Tensor, group) -> Tensor:
    """(n, m) -> (n/P, P m): row block j goes to rank j; the column blocks
    received are concatenated in rank order."""
    p = dist.get_world_size(group)
    n, m = x.shape
    if n % p:
        raise ValueError(f"all_to_all_features: a batch of {n} rows does not split over {p} shards")
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out.reshape(p, n // p, m).permute(1, 0, 2).reshape(n // p, p * m)


class _AllToAllFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _tiled_all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        # the reverse all-to-all: column block k of the cotangent goes back
        # to rank k, whose rows it received are stacked in rank order
        p = dist.get_world_size(ctx.group)
        rows, d = g.shape
        blocks = g.reshape(rows, p, d // p).permute(1, 0, 2).contiguous()
        out = torch.empty_like(blocks)
        dist.all_to_all_single(out, blocks, group=ctx.group)
        return out.reshape(p * rows, d // p), None


# ---------------------------------------------------------------------------
# Small collective helpers
# ---------------------------------------------------------------------------


def psum_if(x: Tensor, axis_name: Optional[AxisName]) -> Tensor:
    """All-reduce SUM over ``axis_name`` when given, identity otherwise."""
    if axis_name is None:
        return x
    return _Psum.apply(x, axis_groups(axis_name))


def pvary_if(x: Tensor, axis_name: Optional[AxisName]) -> Tensor:
    """Mark a value replicated over ``axis_name`` as feeding this rank's
    share of a computation that varies over it: the identity forward, an
    all-reduce of the cotangent backward.  Identity without an axis."""
    if axis_name is None:
        return x
    return _Pvary.apply(x, axis_groups(axis_name))


def effective_batch(n_local: int, axis_name: Optional[AxisName]) -> float:
    """Global batch size as a STATIC float (n_local when no axis)."""
    if axis_name is None:
        return float(n_local)
    return float(n_local) * axis_size(axis_name)


def all_to_all_features(z: Tensor, model_axis: str) -> Tensor:
    """(n, d_local) -> (n/P, d): split the batch, exchange, concatenate the
    features.  Requires features laid out contiguously by shard index along
    ``model_axis`` (the natural layout of a TP projector output)."""
    (group,) = axis_groups(model_axis)
    return _AllToAllFeatures.apply(z, group)


# ---------------------------------------------------------------------------
# R_sum from (already reduced + normalized) frequency accumulators
# ---------------------------------------------------------------------------


def reg_from_freq(g: Tensor, d: int, q: int) -> Tensor:
    """R_sum from an (already normalized) (d//2+1,) frequency accumulator."""
    if q == 2:
        sq, s0 = sv.sq_sum_and_zeroth_from_freq(g, d)
        return sq - s0**2
    svec = torch.fft.irfft(g, n=d, dim=-1)
    return torch.sum(torch.abs(svec[..., 1:]))


def grouped_reg_from_freq(g: Tensor, b: int, q: int) -> Tensor:
    """R_sum^(b) from an (already normalized) (nb, nb, b//2+1) accumulator."""
    nb = g.shape[0]
    eye = torch.eye(nb, dtype=torch.float32, device=g.device)
    if q == 2:
        sq, s0 = sv.sq_sum_and_zeroth_from_freq(g, b)
        return torch.sum(sq) - torch.sum(eye * s0**2)
    svec = torch.fft.irfft(g, n=b, dim=-1)
    full = torch.sum(torch.abs(svec), dim=-1)
    return torch.sum(full) - torch.sum(eye * torch.abs(svec[..., 0]))


def _grouped_route(z: Tensor, impl: Optional[str]) -> str:
    if impl is None:
        from repro_torch.tune.dispatch import best_impl

        impl = best_impl("r_sum_grouped", z.device)
    if impl not in regs.IMPLS:
        raise ValueError(f"impl must be one of {regs.IMPLS}, got {impl!r}")
    return impl


def frequency_accumulator(
    z1: Tensor, z2: Tensor, block_size: Optional[int], *, impl: Optional[str] = None
) -> Tensor:
    """The additive statistic every distributed mode all-reduces.

    Ungrouped (block covers d): the ``torch.fft`` rfft accumulator,
    (d//2+1,) complex64 — the four-step kernel pipeline is a time-domain
    algorithm with no frequency accumulator midway, so the distributed modes
    always take the rfft here, as the reference does.  Grouped, on the
    plain route: ``torch.fft``, (nb, nb, b//2+1) complex64 (the reference's
    layout).  Grouped, on the kernel route (a CUDA tensor, or
    ``impl="kernel"``): the block-DFT kernels (``pmatmul`` + two
    ``freq_outer``; their vjps ``pmatmul`` and ``freq_mat``) give the two
    f32 planes, stacked as (2, nf, nb, nb) — one all-reduce, and then the
    same post-processing as the local kernel route
    (``grouped_sumvec.ops.reg_from_planes``).  ``reg_from_accumulator``
    takes every layout.
    """
    d = z1.shape[-1]
    if block_size is None or block_size >= d:
        return sv.frequency_accumulator(z1, z2)
    b = int(block_size)
    if _grouped_route(z1, impl) == "kernel":
        return torch.stack(gops.grouped_frequency_accumulator_kernel(z1, z2, b))
    return sv.grouped_frequency_accumulator(z1, z2, b)


def reg_from_accumulator(g: Tensor, d: int, block_size: Optional[int], q: int) -> Tensor:
    """R_sum from an (already reduced and normalized) accumulator of
    ``frequency_accumulator``'s layouts, for features of width d."""
    if block_size is None or block_size >= d:
        return reg_from_freq(g, d, q)
    if g.is_complex():
        return grouped_reg_from_freq(g, int(block_size), q)
    return gops.reg_from_planes(g[0], g[1], int(block_size), q)


# ---------------------------------------------------------------------------
# Mode primitives (the surface of the reference's core/distributed.py)
# ---------------------------------------------------------------------------


def r_sum_global(
    z1: Tensor,
    z2: Tensor,
    *,
    axis_name: AxisName,
    q: int = 2,
    block_size: Optional[int] = None,
    scale: Optional[float] = None,
    impl: Optional[str] = None,
) -> Tensor:
    """Exact global-batch R_sum with one all-reduce of the accumulator.

    ``z1, z2``: this rank's (n_local, d) shard of the standardized /
    centered views.  ``scale``: the *local* normalizer (n_local or
    n_local - 1); it is multiplied by the axis size, so the result matches
    one device on the concatenated batch.  (The engine passes exact global
    scales instead.)
    """
    s = (1.0 if scale is None else float(scale)) * axis_size(axis_name)
    return r_sum_from_psummed(z1, z2, axis_name, q=q, block_size=block_size, total_scale=s, impl=impl)


def r_sum_from_psummed(
    z1: Tensor,
    z2: Tensor,
    axis_name: Optional[AxisName],
    *,
    q: int,
    block_size: Optional[int],
    total_scale: float,
    impl: Optional[str] = None,
) -> Tensor:
    """R_sum of the all-reduced accumulator with an explicit TOTAL normalizer."""
    g = frequency_accumulator(z1, z2, block_size, impl=impl)
    g = psum_if(g, axis_name) / float(total_scale)
    return reg_from_accumulator(g, z1.shape[-1], block_size, q)


def r_sum_tp(
    z1: Tensor,
    z2: Tensor,
    *,
    model_axis: str,
    batch_axis: Optional[AxisName] = None,
    q: int = 2,
    block_size: Optional[int] = None,
    scale: Optional[float] = None,
    perm: Optional[Tensor] = None,
    impl: Optional[str] = None,
) -> Tensor:
    """R_sum when the feature dim is sharded over ``model_axis``.

    Each rank holds (n, d_local) with d = P * d_local, features contiguous
    by shard index.  One all-to-all gives (n / P, d) full-feature rows, then
    the accumulator is all-reduced over the model axis (batch chunks) and,
    if given, the batch axis (data shards).  ``perm``: the feature
    permutation (indices), applied to the full-feature rows after the
    transpose — the same indices on every rank give exactly the permutation
    one device applies to the unsharded d.  ``scale`` is the local batch's
    normalizer, multiplied by the batch axis's size.
    """
    from repro_torch.core import permutation as perm_lib

    same = z1 is z2
    z1f = all_to_all_features(z1.float(), model_axis)
    z2f = z1f if same else all_to_all_features(z2.float(), model_axis)
    if perm is not None:
        z1f, z2f = perm_lib.permute_views(perm, z1f, z2f)
    g = frequency_accumulator(z1f, z2f, block_size, impl=impl)
    g = psum_if(g, model_axis)
    s = 1.0 if scale is None else float(scale)
    if batch_axis is not None:
        g = psum_if(g, batch_axis)
        s *= axis_size(batch_axis)
    return reg_from_accumulator(g / s, z1f.shape[-1], block_size, q)


def r_off_global(z1: Tensor, z2: Tensor, *, axis_name: Optional[AxisName], total_scale: float) -> Tensor:
    """Exact global-batch R_off via one all-reduce of the d x d product.

    O(d^2) traffic — the baseline's irreducible cost, kept for like-for-like
    comparisons; the R_sum modes above are the O(d) path.  The reference
    forms this matrix outside its kernels, so it is a plain ``matmul`` here.
    """
    c = z1.float().T @ z2.float()
    return regs.r_off(psum_if(c, axis_name) / float(total_scale))


# ---------------------------------------------------------------------------
# What one device computes on the concatenated global batch (the oracle)
# ---------------------------------------------------------------------------


def r_sum_single_device(z1, z2, *, q=2, block_size=None, scale=None, impl=None):
    """``core/regularizers.r_sum_auto`` on the whole batch."""
    return regs.r_sum_auto(z1, z2, q=q, block_size=block_size, scale=scale, impl=impl)
