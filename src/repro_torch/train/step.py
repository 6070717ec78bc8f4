"""The LM train step and the compressed data-parallel step (port of ``repro/train/step.py``).

``make_train_step`` builds the step of any arch of ``repro_torch.configs``:

    loss = CE + router-balance aux (MoE) + decorrelation aux

the last being the paper's regularizer on the final hidden states
(``core/decorrelation.py``): on a CUDA tensor its R runs the hand-written
kernels forward and backward (their vjps), on a CPU tensor their plain
versions.

Features, as in the reference:
  * gradient accumulation: ``num_microbatches`` splits the batch and sums
    the gradients in f32 over the microbatches, then divides;
  * global-norm clipping;
  * a deterministic per-step feature permutation (restart-safe): by default
    ``permutation_for_step(state.seed, step, d_model)``.  The reference
    draws it from JAX's threefry stream, which torch cannot reproduce; a
    comparison with the reference hands in the reference's own indices
    through ``perm_fn``.

The parameters are a ``models.ParamTree`` in ``TrainState.model``.  Every
gradient is complete before the optimizer touches a parameter, so a fault
raised during the forward or backward pass leaves the state as it was and
the loop's retry can replay the step.

Over a ``DeviceMesh`` (``mesh=``, or a mesh installed with
``parallel.sharding.sharding_context``) the step is data-parallel: every
rank steps on its block of the batch, and the loss is the whole batch's,
as the reference's GSPMD step computes it over the global array — the CE a
mean over every rank's tokens, the decorrelation aux loss on every rank's
subsampled rows gathered over ``data_axis`` (each rank runs the one-device
route's kernels on the whole batch's rows; the gather's backward takes
this rank's rows back), the MoE router's fractions and capacity positions over the whole
batch (``models/moe.py``).  Each rank's backward of that replicated loss
gives its share of every gradient; a microbatch's shares are all-reduced
into a replicated f32 accumulator, or, with ``grad_shardings``,
reduce-scattered into this rank's shard of it (2 (data - 1) / data less
collective volume a microbatch) and gathered once before the clip and the
optimizer.  A rank's microbatch i is its block's i-th slice, so the
global microbatch i is the ranks' i-th slices together.

A state ``parallel/fsdp_tp.place_train_state`` placed takes the
reference's 2-D layout instead (the step follows the state, as GSPMD's
follows the parameters' shardings): each rank holds its block of every
parameter and both AdamW moments (FSDP over "data", TP over "model") and
its block of the batch over ``("pod", "data")``.  The forward gathers each
layer's blocks over "data" inside its rematerialised block and runs heads,
MLP columns and vocabulary columns tensor-parallel (``models/``); the CE is
vocabulary-parallel; the aux loss runs on the gathered rows, as above.
MoE experts run expert-parallel over "model", Mamba channels and RWKV6
heads tensor-parallel (``parallel/fsdp_tp``'s module note).  The gathers'
backward reduce-scatters each block's gradient, the blocks are all-reduced
over "pod" and the leaves that do not split over "data" over the batch
axes; the clip counts each leaf once and AdamW steps each block.

``make_compressed_dp_step`` is the explicit data-parallel variant: every
rank of a mesh steps on its batch slice and the gradients are summed over
the data axis through a compressed all-reduce (``optim/compression.py``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.decorrelation import lm_decorrelation_loss, subsample_tokens
from repro_torch.core.permutation import permutation_for_step
from repro_torch.decorr.modes import psum_if
from repro_torch.kernels.utils import is_fake
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import forward, vocab_start
from repro_torch.optim import compression as comp
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm_
from repro_torch.parallel import fsdp_tp
from repro_torch.parallel import sharding as shd
from repro_torch.train.train_state import TrainState

Tensor = torch.Tensor


def cross_entropy(logits: Tensor, labels: Tensor, vocab_start: Optional[int] = None,
                  vocab_size: Optional[int] = None) -> Tensor:
    """Mean CE. logits (..., V), taken in f32; labels (...) integer ids
    (extra dims fine: audio codes' (B, S, n_codebooks)).

    With ``vocab_start`` the CE is vocabulary-parallel over mesh axis
    "model": ``logits`` (..., C) are this rank's columns [start, start + C)
    of the flat (n_codebooks x ``vocab_size``) vocabulary, and ``labels``
    (...) or (..., n_codebooks) the ids of each codebook.  Each codebook's
    log-sum-exp is the ranks' local ones combined, M + log(sum over ranks
    of exp(lse_r - M)) with M their all-reduced max (no gradient), and the
    gold logit comes from the rank that holds it (zero elsewhere,
    all-reduced); the result is the same on every rank, and on one rank it
    is the unsplit CE's to the bit."""
    logits = logits.float()
    if vocab_start is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return torch.mean(logz - gold)
    lab = labels.long() if labels.dim() == logits.dim() else labels.long()[..., None]
    n_q, c = lab.shape[-1], logits.shape[-1]
    if n_q == 1:
        local = torch.logsumexp(logits, dim=-1, keepdim=True)
    else:
        # each column's codebook: a rank's columns may span several, and a
        # codebook it holds no column of has a local log-sum-exp of -inf
        seg = torch.div(vocab_start + torch.arange(c, device=logits.device), vocab_size, rounding_mode="floor")
        seg = seg.expand_as(logits)
        peak = logits.detach().new_full(lab.shape, float("-inf")).scatter_reduce(-1, seg, logits.detach(), "amax")
        held = torch.isfinite(peak)
        peak = torch.where(held, peak, torch.zeros_like(peak))
        sums = logits.new_zeros(lab.shape).scatter_add(-1, seg, torch.exp(logits - peak.gather(-1, seg)))
        local = torch.where(held, torch.log(torch.where(held, sums, torch.ones_like(sums))) + peak, float("-inf"))
    top = local.detach().clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=shd.axis_groups("model")[0])
    logz = top + torch.log(psum_if(torch.exp(local - top), "model"))
    col = torch.arange(n_q, device=lab.device) * (vocab_size or c) + lab - vocab_start
    own = (col >= 0) & (col < c)
    gold = torch.gather(logits, -1, col.clamp(0, c - 1)) * own
    return torch.mean(logz - psum_if(gold, "model"))


def _lm_loss_fn(params, batch: Mapping[str, Tensor], cfg: ArchConfig, perm: Optional[Tensor] = None, *,
                impl: Optional[str] = None, axis_name=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """(loss, metrics) of one batch: ``tokens`` or a frontend's ``embeds``,
    optional ``positions`` (M-RoPE's (3, B, S)), ``labels``.  ``perm``: the
    step's feature permutation; ``impl``: the aux regularizer's route.
    ``axis_name`` (a mesh axis or a tuple of them): the batch is this rank's
    block of one sharded over it, and the loss is the whole batch's (the
    same on every rank): the aux loss runs on every batch rank's subsampled
    rows gathered over it, so its regularizer runs the kernels of the
    one-device route on the whole batch's rows."""
    kwargs = {"embeds": batch["embeds"]} if "embeds" in batch else {"tokens": batch["tokens"]}
    if "positions" in batch:
        kwargs["positions"] = batch["positions"]
    dcfg = cfg.decorr
    with shd.data_parallel(axis_name):
        out = forward(params, cfg, **kwargs)
    # placed blocks (the 2-D step) give this rank's vocabulary columns
    ce = cross_entropy(out.logits, batch["labels"], vocab_start(params, cfg), cfg.vocab_size)
    if axis_name is not None:
        # equal blocks: the whole batch's mean is the mean of the ranks' means
        ce = psum_if(ce, axis_name) / shd.axis_size(axis_name)
    hidden = out.hidden
    if axis_name is not None and dcfg.enabled:
        # the subsampled rows of every batch rank, (B, take, d) a rank, in
        # the blocks' order (the aux is a sum over rows: any order would do)
        b, _, d = hidden.shape
        rows = subsample_tokens(hidden, dcfg.tokens_per_seq).reshape(b, -1, d)
        hidden = fsdp_tp.gather_rows(rows, axis_name)
    decorr, dmetrics = lm_decorrelation_loss(hidden, dcfg, perm, impl=impl)
    moe_aux = out.aux["moe_aux"] * cfg.router_aux_weight
    loss = ce + decorr + moe_aux
    return loss, {"loss": loss, "ce": ce, "moe_aux": moe_aux, **dmetrics}


def _split(batch: Mapping[str, Tensor], n: int) -> List[Dict[str, Tensor]]:
    """``n`` microbatches along each leaf's batch axis (M-RoPE positions
    (3, B, S): axis 1)."""
    def axis(key, x):
        return 1 if key == "positions" and x.dim() == 3 else 0

    parts = {k: torch.chunk(x, n, dim=axis(k, x)) for k, x in batch.items()}
    for k, x in batch.items():
        if x.shape[axis(k, x)] % n:
            raise ValueError(f"batch leaf {k!r} of {x.shape[axis(k, x)]} rows does not split into {n} microbatches")
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def _grads(loss: Tensor, params: List[Tensor]) -> List[Tensor]:
    # a parameter the loss does not reach gets a zero gradient, as jax.grad gives
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]


def _grad_plan(grad_shardings, params: List[Tensor], data_axis, n: int) -> List[Optional[int]]:
    """Per parameter: the dimension its gradient is reduce-scattered along
    (the one dimension its spec splits over exactly the ``data_axis`` axes,
    ``n`` dividing it), or None for the all-reduce fallback."""
    specs = list(grad_shardings)
    if len(specs) != len(params):
        raise ValueError(f"grad_shardings has {len(specs)} specs for {len(params)} parameters")
    axes = shd._names(data_axis)
    plan: List[Optional[int]] = []
    for spec, p in zip(specs, params):
        spec = tuple(getattr(spec, "spec", spec) or ())
        dims = [i for i, e in enumerate(spec) if e is not None]
        names = [shd._names(e) for e in spec if e is not None]
        ok = len(dims) == 1 and names[0] == axes and dims[0] < p.dim() and p.shape[dims[0]] % n == 0
        plan.append(dims[0] if ok else None)
    return plan


def _reduce_scatter(g: Tensor, dim: int, groups) -> Tensor:
    """This rank's block (along ``dim``) of the sum of ``g`` over ``groups``
    (each in turn, the major axis first: the blocks' row-major order)."""
    for group in groups:
        g = fsdp_tp.reduce_scatter_dim(g, dim, group)
    return g


def _all_gather(shard: Tensor, dim: int, groups) -> Tensor:
    """The full tensor from every rank's block (``_reduce_scatter``'s layout)."""
    for group in reversed(groups):
        shard = fsdp_tp.gather_dim(shard, dim, group)
    return shard


def make_train_step(
    cfg: ArchConfig,
    optimizer: Optimizer,
    schedule: Callable[[int], float],
    num_microbatches: int = 1,
    clip_norm: Optional[float] = 1.0,
    loss_fn=None,
    perm_fn: Optional[Callable[[int], Tensor]] = None,
    *,
    impl: Optional[str] = None,
    grad_shardings=None,
    mesh=None,
    data_axis: str = "data",
):
    """``train_step(state, batch) -> (state, metrics)``, updating ``state``
    in place.

    ``batch``: device tensors (see ``_lm_loss_fn``).  ``loss_fn(params,
    batch, perm=perm) -> (loss, metrics)`` replaces the LM loss.  ``perm_fn(step)``
    gives the step's feature permutation (default
    ``permutation_for_step(state.seed, step, cfg.d_model)``; drawn only when
    the aux loss is on and permutes).  ``impl`` overrides the aux
    regularizer's route (``"plain"`` on a CUDA device is how the smoke holds
    the kernel route).  Metrics stay device tensors (no host sync), plus
    ``grad_norm`` and ``lr`` (the schedule's host float).  With
    ``num_microbatches`` > 1 the gradients are summed in f32 and averaged,
    and the clip and the optimizer take those f32 gradients whatever the
    parameters' dtype, as the reference's do; with one microbatch they keep
    the parameters' dtype, as the reference's ``value_and_grad`` gives them.

    Data-parallel (``mesh``, or an installed ``sharding_context``; see the
    module docstring): ``batch`` is this rank's block, ``num_microbatches``
    splits it.  A custom ``loss_fn`` must return the whole batch's loss
    (replicated over ``data_axis``) itself.  ``grad_shardings``: one spec per
    parameter of ``state.model.parameters()`` (a spec tuple or a
    ``NamedSharding``, usually ``("data", None, ...)``, the reference's
    ``fsdp`` rule); with microbatches (one microbatch is not sharded, as
    in the reference), each microbatch's gradient is
    reduce-scattered into this rank's shard of the accumulator along the
    dimension the spec splits over ``data_axis``.  A spec that does not
    divide its leaf (or splits over anything else) falls back to the
    all-reduce for that leaf, counted in ``metrics["grad_shard_fallbacks"]``.
    ``data_axis`` may be a tuple of mesh axes (``("pod", "data")``): the
    batch is split over their product.

    A placed state (``parallel/fsdp_tp.place_train_state``) takes the 2-D
    step (see the module docstring) on the state's own mesh; ``batch`` is
    this rank's block over ``("pod", "data")`` (whichever the mesh has), and
    ``grad_shardings``, if given, must be the blocks' own specs (a no-op).
    """
    wants_perm = cfg.decorr.enabled and cfg.decorr.decorr.permute and cfg.decorr.decorr.reg == "sum"

    def step_perm(state: TrainState, device) -> Optional[Tensor]:
        if not wants_perm:
            return None
        perm = perm_fn(state.step) if perm_fn is not None else permutation_for_step(
            state.seed, state.step, cfg.d_model)
        if device.type == "cuda" and not perm.is_cuda and not is_fake(perm):
            # a pageable host->device copy would stall the host on the stream
            # (an analysis's fake copy has no host memory to pin)
            perm = perm.pin_memory().to(device, non_blocking=True)
        return perm.to(device)

    def average(metric_list):
        if len(metric_list) == 1:
            return dict(metric_list[0])
        total = metric_list[0]
        for m in metric_list[1:]:
            total = {k: total[k] + m[k] for k in total}
        return {k: v / len(metric_list) for k, v in total.items()}

    def finish(state, grads, metrics, params=None):
        if clip_norm is not None:
            metrics["grad_norm"] = clip_by_global_norm_(grads, clip_norm, params=params)
        lr = schedule(state.step)
        metrics["lr"] = lr
        # every gradient is complete: only now does anything change in place
        state.opt_state.step(lr, grads)
        state.step += 1
        return state, metrics

    def microbatches(state, batch, perm, lfn):
        """(gradients, detached metrics) of each microbatch in turn (f32
        with microbatches; the parameters' dtype with one)."""
        params = list(state.model.parameters())
        tree = state.model.tree()
        if num_microbatches <= 1:
            loss, m = lfn(tree, batch, perm=perm)
            yield _grads(loss, params), {k: v.detach() for k, v in m.items()}
            return
        for mb in _split(batch, num_microbatches):
            loss, m = lfn(tree, mb, perm=perm)
            yield [x.float() for x in _grads(loss, params)], {k: v.detach().float() for k, v in m.items()}

    single_loss = loss_fn or functools.partial(_lm_loss_fn, cfg=cfg, impl=impl)

    def single_step(state, batch):
        params = list(state.model.parameters())
        perm = step_perm(state, params[0].device)
        acc, metrics = None, []
        for g, m in microbatches(state, batch, perm, single_loss):
            acc = g if acc is None else [a.add_(x) for a, x in zip(acc, g)]
            metrics.append(m)
        grads = acc if num_microbatches <= 1 else [a.div_(num_microbatches) for a in acc]
        return finish(state, grads, average(metrics))

    dp_loss = loss_fn or functools.partial(_lm_loss_fn, cfg=cfg, impl=impl, axis_name=data_axis)

    def dp_step(state, batch, dp_mesh):
        params = list(state.model.parameters())
        perm = step_perm(state, params[0].device)
        with shd.sharding_context(dp_mesh) if dp_mesh is not shd.current_mesh() else contextlib.nullcontext():
            n = shd.axis_size(data_axis)
            groups = shd.axis_groups(data_axis)
            plan = [None] * len(params)
            if grad_shardings is not None and num_microbatches > 1:
                plan = _grad_plan(grad_shardings, params, data_axis, n)
            acc, metrics = None, []
            for g, m in microbatches(state, batch, perm, dp_loss):
                g = [x.float() for x in g]
                # the all-reduce for the replicated leaves (one flat buffer),
                # the reduce-scatter for the sharded ones
                dense = [i for i, d in enumerate(plan) if d is None]
                summed = dict(zip(dense, comp.psum([g[i] for i in dense], data_axis)))
                red = [summed[i] if d is None else _reduce_scatter(g[i], d, groups) for i, d in enumerate(plan)]
                acc = red if acc is None else [a.add_(x) for a, x in zip(acc, red)]
                metrics.append(m)
            acc = [a.div_(num_microbatches) if num_microbatches > 1 else a for a in acc]
            grads = [a if d is None else _all_gather(a, d, groups) for a, d in zip(acc, plan)]
        if num_microbatches <= 1:
            # one microbatch: the parameters' dtype, as the reference's value_and_grad
            grads = [g.to(p.dtype) for g, p in zip(grads, params)]
        metrics = average(metrics)
        if grad_shardings is not None and num_microbatches > 1:
            metrics["grad_shard_fallbacks"] = float(sum(d is None for d in plan))
        return finish(state, grads, metrics)

    def placed_step(state, batch):
        named = list(state.model.named_parameters())
        params = [p for _, p in named]
        shardings = [state.shardings[name] for name, _ in named]
        if grad_shardings is not None:
            want = [tuple(getattr(s, "spec", s) or ()) for s in grad_shardings]
            if want != [tuple(sh.spec) for sh in shardings]:
                raise ValueError("grad_shardings of a placed state must be its blocks' own specs (they are "
                                 "then a no-op: each block's gradient is reduce-scattered into it)")
        layout = shardings[0].mesh
        axes = tuple(a for a in ("pod", "data") if a in (layout.mesh_dim_names or ()))
        perm = step_perm(state, params[0].device)
        lfn = loss_fn or functools.partial(_lm_loss_fn, cfg=cfg, impl=impl, axis_name=axes)
        with shd.sharding_context(layout) if layout is not shd.current_mesh() else contextlib.nullcontext():
            acc, metrics = None, []
            for g, m in microbatches(state, batch, perm, lfn):
                acc = g if acc is None else [a.add_(x) for a, x in zip(acc, g)]
                metrics.append(m)
            if num_microbatches > 1:
                acc = [a.div_(num_microbatches) for a in acc]
            # a block split over "data" had its gradient reduce-scattered by
            # its gathers; every leaf is replicated over "pod", the others
            # over "data" too
            for over, keep in ((axes, False), (tuple(a for a in axes if a != "data"), True)):
                idx = [i for i, p in enumerate(params) if fsdp_tp.split_over(p, fsdp_tp.DATA) == keep]
                if over and idx:
                    for i, g in zip(idx, comp.psum([acc[i] for i in idx], over)):
                        acc[i] = g
        grads = acc
        if num_microbatches <= 1:
            grads = [g.to(p.dtype) for g, p in zip(grads, params)]
        return finish(state, grads, average(metrics), params=params)

    def train_step(state: TrainState, batch: Mapping[str, Tensor]) -> Tuple[TrainState, Dict]:
        if not isinstance(state.opt_state, optimizer.cls):
            raise TypeError(f"state holds a {type(state.opt_state).__name__}, the step was made for {optimizer.name}")
        if fsdp_tp.is_placed(state):
            return placed_step(state, batch)
        dp_mesh = mesh if mesh is not None else shd.current_mesh()
        if dp_mesh is None:
            return single_step(state, batch)
        return dp_step(state, batch, dp_mesh)

    return train_step


# ---------------------------------------------------------------------------
# Explicit data-parallel variant with a compressed gradient all-reduce
# ---------------------------------------------------------------------------

COMPRESSIONS = ("none", "bf16", "int8_ef")


def make_compressed_dp_step(
    loss_fn,
    optimizer: Optimizer,
    schedule: Callable[[int], float],
    axis_name: str = "data",
    compression: str = "int8_ef",
    *,
    mesh=None,
    perm_fn: Optional[Callable[[int], Tensor]] = None,
):
    """Per-rank loss + an explicit compressed all-reduce of the gradients.

    ``step(state, batch, ef_errors) -> (state, metrics, ef_errors)`` runs on
    every rank of ``mesh`` (default: the mesh installed by
    ``parallel.sharding.sharding_context``) with this rank's batch slice.
    ``loss_fn(model, batch, perm=) -> (loss, metrics)`` takes the port's
    loss signature (an LM loss reads ``model.tree()``); ``perm_fn(step)``
    gives the step's permutation (None: no permutation).  ``compression``:

      * ``none``    — the f32 mean over ``axis_name``;
      * ``bf16``    — summed in bf16 (``bf16_psum``), divided by the axis size;
      * ``int8_ef`` — summed in int8 with error feedback (``int8_psum_ef``),
        divided by the axis size; ``ef_errors`` (from
        ``optim.compression.init_error_feedback`` over the parameters) are
        this rank's carried residuals, returned updated.

    The optimizer takes the f32 reduced gradients whatever the parameters'
    dtype, every one complete before it moves a parameter.  Metrics are the
    mean over the axis; ``lr`` is the schedule's host float.
    """
    if compression not in COMPRESSIONS:
        raise ValueError(f"compression must be one of {COMPRESSIONS}, got {compression!r}")

    def step(state: TrainState, batch: Mapping[str, Tensor], ef_errors):
        if not isinstance(state.opt_state, optimizer.cls):
            raise TypeError(f"state holds a {type(state.opt_state).__name__}, the step was made for {optimizer.name}")
        params = list(state.model.parameters())
        perm = None if perm_fn is None else perm_fn(state.step).to(params[0].device)
        with shd.sharding_context(mesh) if mesh is not None else contextlib.nullcontext():
            loss, metrics = loss_fn(state.model, batch, perm=perm)
            grads = [g.float() for g in _grads(loss, params)]
            n = shd.axis_size(axis_name)
            if compression == "bf16":
                grads = comp.bf16_psum(grads, axis_name)
            elif compression == "int8_ef":
                grads, ef_errors = comp.int8_psum_ef(grads, ef_errors, axis_name)
            else:
                grads = comp.psum(grads, axis_name)
            grads = [g.div_(n) for g in grads]
            names = list(metrics)
            means = comp.psum([torch.stack([metrics[k].detach().float() for k in names])], axis_name)[0] / n
        metrics = dict(zip(names, means))
        lr = schedule(state.step)
        metrics["lr"] = lr
        state.opt_state.step(lr, grads)
        state.step += 1
        return state, metrics, ef_errors

    return step
