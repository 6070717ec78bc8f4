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

``make_compressed_dp_step`` is the explicit data-parallel variant: every
rank of a mesh steps on its batch slice and the gradients are summed over
the data axis through a compressed all-reduce (``optim/compression.py``).
The sharded accumulator (``grad_shardings``) belongs to a later slice of
the port.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.core.decorrelation import lm_decorrelation_loss
from repro_torch.core.permutation import permutation_for_step
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import forward
from repro_torch.optim import compression as comp
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm_
from repro_torch.parallel import sharding as shd
from repro_torch.train.train_state import TrainState

Tensor = torch.Tensor


def cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean CE. logits (..., V), taken in f32; labels (...) integer ids
    (extra dims fine: audio codes' (B, S, n_codebooks))."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def _lm_loss_fn(params, batch: Mapping[str, Tensor], cfg: ArchConfig, perm: Optional[Tensor] = None, *,
                impl: Optional[str] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """(loss, metrics) of one batch: ``tokens`` or a frontend's ``embeds``,
    optional ``positions`` (M-RoPE's (3, B, S)), ``labels``.  ``perm``: the
    step's feature permutation; ``impl``: the aux regularizer's route."""
    kwargs = {"embeds": batch["embeds"]} if "embeds" in batch else {"tokens": batch["tokens"]}
    if "positions" in batch:
        kwargs["positions"] = batch["positions"]
    out = forward(params, cfg, **kwargs)
    ce = cross_entropy(out.logits, batch["labels"])
    decorr, dmetrics = lm_decorrelation_loss(out.hidden, cfg.decorr, perm, impl=impl)
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
    """
    loss_fn = loss_fn or functools.partial(_lm_loss_fn, cfg=cfg, impl=impl)
    dcfg = cfg.decorr.decorr
    wants_perm = cfg.decorr.enabled and dcfg.permute and dcfg.reg == "sum"

    def train_step(state: TrainState, batch: Mapping[str, Tensor]) -> Tuple[TrainState, Dict]:
        if not isinstance(state.opt_state, optimizer.cls):
            raise TypeError(f"state holds a {type(state.opt_state).__name__}, the step was made for {optimizer.name}")
        params = list(state.model.parameters())
        tree = state.model.tree()
        perm = None
        if wants_perm:
            device = params[0].device
            perm = perm_fn(state.step) if perm_fn is not None else permutation_for_step(
                state.seed, state.step, cfg.d_model)
            if device.type == "cuda" and not perm.is_cuda:
                # a pageable host->device copy would stall the host on the stream
                perm = perm.pin_memory().to(device, non_blocking=True)
            perm = perm.to(device)

        if num_microbatches <= 1:
            loss, metrics = loss_fn(tree, batch, perm=perm)
            grads = _grads(loss, params)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            acc, metrics = None, None
            for mb in _split(batch, num_microbatches):
                loss, m = loss_fn(tree, mb, perm=perm)
                g = _grads(loss, params)
                acc = [x.float() for x in g] if acc is None else [a.add_(x.float()) for a, x in zip(acc, g)]
                m = {k: v.detach().float() for k, v in m.items()}
                metrics = m if metrics is None else {k: metrics[k] + m[k] for k in metrics}
            grads = [a.div_(num_microbatches) for a in acc]
            metrics = {k: v / num_microbatches for k, v in metrics.items()}

        if clip_norm is not None:
            metrics["grad_norm"] = clip_by_global_norm_(grads, clip_norm)
        lr = schedule(state.step)
        metrics["lr"] = lr
        # every gradient is complete: only now does anything change in place
        state.opt_state.step(lr, grads)
        state.step += 1
        return state, metrics

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
