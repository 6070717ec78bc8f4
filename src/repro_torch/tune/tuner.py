"""The tuner: search a config space and persist the winner (port of
``repro/tune/tuner.py``).

Modes:
  * ``analytic`` — rank by the closed-form model only.  Instant.
  * ``dry``      — count each candidate's FLOPs and bytes with the op-level
                   analyzer on fake copies of its inputs
                   (``cost.compiled_cost``): the kernel route on a card
                   (each launch at its C entry's formula), the plain route
                   on the CPU.  Nothing runs or is timed: deterministic
                   everywhere.
  * ``measure``  — time each candidate once (best of ``repeats`` calls) on
                   ``device``: a plan candidate as the whole regularizer
                   call, forward and backward, on the kernel route under
                   ``override``; a page candidate as one ``paged_attention``
                   launch at the pool's shape; a tile kernel's one config as
                   one launch of its kernel (recorded, nothing to choose).

``guard_default=True`` accepts a winner only if it is no worse than the
default: on counted FLOPs and bytes in ``dry`` mode, on time in
``measure`` mode.  The call sites resolve their configs at call time, so a
tuned winner reaches the very next call; a tune whose disk cache already
holds an entry of the same tier or a higher one (analytic < dry < measure)
for the key returns it and evaluates nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.tune import cache as _cache
from repro_torch.tune import cost as _cost
from repro_torch.tune import dispatch as _dispatch
from repro_torch.tune import space as _space

Config = Dict[str, int]
MODES = ("analytic", "dry", "measure")


@dataclasses.dataclass
class Candidate:
    config: Config
    cost: Dict[str, float]
    time_us: Optional[float] = None


@dataclasses.dataclass
class TuneResult:
    kernel: str
    shape: Tuple[int, ...]
    dtype: str
    backend: str
    mode: str
    best: Config
    default: Config
    candidates: List[Candidate]
    cached: bool = False  # served from the disk cache, nothing evaluated

    def candidate_for(self, config: Config) -> Candidate:
        for c in self.candidates:
            if c.config == config:
                return c
        raise KeyError(config)


# ---------------------------------------------------------------------------
# Builders: (shape, config, device) -> (fn, args).  Kernel modules are
# imported here, not at module top: they import the tuner's dispatch.
# ---------------------------------------------------------------------------


def _ones(device, *shapes, grad=False):
    return [torch.ones(s, dtype=torch.float32, device=device, requires_grad=grad) for s in shapes]


def _fwd_bwd(loss_fn: Callable, overrides: Dict[str, Config]):
    """``fn(z1, z2)``: the loss and its input gradients, under ``overrides``."""
    from repro_torch.tune.dispatch import override

    def fn(z1, z2):
        if not overrides:
            return torch.autograd.grad(loss_fn(z1, z2), (z1, z2))
        ((name, cfg),) = overrides.items()
        with override(name, **cfg):
            return torch.autograd.grad(loss_fn(z1, z2), (z1, z2))

    return fn


def _build(kernel: str, shape: Tuple[int, ...], cfg: Config, device, dtype=torch.float32) -> Tuple[Callable, list]:
    if kernel == "sumvec_fft_plan":
        from repro_torch.core import regularizers as regs

        (d,) = shape
        # at a realistic batch: the inverse stage runs once on the
        # batch-reduced accumulator, so a tiny n would overweight it
        n = _cost.NOMINAL_BATCH
        loss = lambda a, b: regs.r_sum(a, b, q=2, impl="kernel")
        return _fwd_bwd(loss, {kernel: cfg}), _ones(device, (n, d), (n, d), grad=True)
    if kernel == "grouped_block_plan":
        from repro_torch.core import regularizers as regs

        n, d = shape
        loss = lambda a, b: regs.r_sum_grouped(a, b, cfg["b"], q=2, impl="kernel")
        return _fwd_bwd(loss, {}), _ones(device, (n, d), (n, d), grad=True)
    if kernel == "paged_attention":
        from repro_torch.kernels.paged_attention.kernel import paged_decode_attention

        b, s, kv, hd = shape
        page = cfg["page"]
        nb = -(-s // page)
        tables = torch.arange(b * nb, dtype=torch.int32, device=device).reshape(b, nb)
        lens = torch.full((b,), s, dtype=torch.int32, device=device)
        pdt = dtype if dtype in (torch.float32, torch.bfloat16) else torch.float32
        q = torch.ones((b, kv, hd), dtype=torch.float32, device=device)
        kp, vp = (torch.ones((b * nb, page, kv, hd), dtype=pdt, device=device) for _ in range(2))
        fn = lambda q_, k_, v_: paged_decode_attention(q_, k_, v_, tables, lens, scale=1.0 / max(hd, 1) ** 0.5)
        return fn, [q, kp, vp]
    if kernel == "xcorr_offdiag":
        from repro_torch.kernels.xcorr_offdiag.kernel import off_diagonal_sq_sum_raw

        n, d = shape
        return off_diagonal_sq_sum_raw, _ones(device, (n, d), (n, d))
    if kernel == "cmatmul":
        from repro_torch.kernels.sumvec_fft.kernel import cmatmul

        m, k, n = shape
        return torch.no_grad()(cmatmul), _ones(device, (m, k), (m, k), (k, n), (k, n))
    if kernel == "ctwiddle":
        from repro_torch.kernels.sumvec_fft.kernel import ctwiddle

        n, d = shape
        return torch.no_grad()(ctwiddle), _ones(device, (n, d), (n, d), (d,), (d,))
    if kernel == "pmatmul":
        from repro_torch.kernels.grouped_sumvec.kernel import pmatmul

        m, k, n = shape
        return torch.no_grad()(pmatmul), _ones(device, (m, k), (k, n))
    if kernel == "freq_outer":
        from repro_torch.kernels.grouped_sumvec.kernel import freq_outer

        f, k, n = shape
        return torch.no_grad()(freq_outer), _ones(device, (f, k, n), (f, k, n))
    if kernel == "freq_mat":
        from repro_torch.kernels.grouped_sumvec.kernel import freq_mat

        f, k, n, n2 = shape
        return torch.no_grad()(freq_mat), _ones(device, (f, k, n), (f, n, n2))
    raise KeyError(kernel)


def _dry_cost(kernel: str, shape: Tuple[int, ...], cfg: Config, device) -> Dict[str, float]:
    """The candidate's analysed FLOPs and bytes on ``device``'s route,
    beside its analytic launches and shared memory."""
    out = _cost.analytic_cost(kernel, shape, cfg)
    fn, args = _build(kernel, shape, cfg, device)
    out.update(_cost.compiled_cost(fn, *args))
    return out


def _flops_bytes(cost: Dict[str, float]) -> Tuple[float, float]:
    return (cost["flops"], cost["hbm_bytes"])


def _cached_result(kernel, canon, dtype_s, backend, mode, default) -> Optional[TuneResult]:
    """The disk entry for the key when its tier is ``mode``'s or higher."""
    entry = _cache.lookup(kernel, canon, dtype_s, backend)
    if entry is None or entry.get("source") not in MODES:
        return None
    if MODES.index(entry["source"]) < MODES.index(mode):
        return None
    try:
        if not _space.is_legal(kernel, canon, entry["config"]):
            return None
    except (KeyError, TypeError):
        return None
    cost = dict(entry.get("cost") or {})
    time_us = cost.pop("time_us", None)
    best = {k: int(v) for k, v in entry["config"].items()}
    return TuneResult(kernel, canon, dtype_s, backend, entry["source"], best, default,
                      [Candidate(best, cost, time_us)], cached=True)


def tune(
    kernel: str,
    shape,
    dtype=torch.float32,
    *,
    mode: str = "dry",
    max_candidates: int = 6,
    guard_default: bool = True,
    persist: bool = True,
    repeats: int = 3,
    backend: Optional[str] = None,
    device=None,
) -> TuneResult:
    """Search ``kernel``'s config space at ``shape``; install the winner in
    the dispatch memo and, with ``persist``, the disk cache.  ``device``
    matters in ``measure`` mode only (``cuda`` unless ``"cpu"`` is passed;
    raises where CUDA is absent); its backend keys the cache."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    dev = None
    if mode == "measure":
        from repro_torch import resolve_device

        dev = resolve_device(device)
    elif mode == "dry":
        # the route a call on this machine takes: the kernels on a card
        dev = torch.device(device if device is not None else "cuda" if torch.cuda.is_available() else "cpu")
    backend = backend or _cache.backend_key(dev)
    canon = _dispatch.canonical_shape(kernel, shape)
    dtype_s = _dispatch.dtype_str(dtype)
    default = _space.default_config(kernel, canon)

    if persist:
        hit = _cached_result(kernel, canon, dtype_s, backend, mode, default)
        if hit is not None:
            _dispatch.record(kernel, canon, hit.best, dtype, backend=backend)
            return hit

    cands = _space.candidates(kernel, canon)
    cands.sort(key=lambda c: _cost.rank_key(_cost.analytic_cost(kernel, canon, c), kernel))
    if max_candidates and len(cands) > max_candidates:
        cands = cands[:max_candidates]
    if default not in cands:
        cands.append(default)

    evaluated: List[Candidate] = []
    if mode == "analytic":
        for cfg in cands:
            evaluated.append(Candidate(cfg, _cost.analytic_cost(kernel, canon, cfg)))
        best = min(evaluated, key=lambda c: _cost.rank_key(c.cost, kernel)).config
    else:
        for cfg in cands:
            if mode == "dry":
                evaluated.append(Candidate(cfg, _dry_cost(kernel, canon, cfg, dev)))
            else:
                fn, args = _build(kernel, canon, cfg, dev, dtype)
                t = _cost.measured_time_us(fn, *args, repeats=repeats)
                evaluated.append(Candidate(cfg, _cost.analytic_cost(kernel, canon, cfg), t))
        default_cand = next(c for c in evaluated if c.config == default)
        pool = evaluated
        if mode == "dry":
            if guard_default:
                pool = [c for c in evaluated
                        if c.cost["flops"] <= default_cand.cost["flops"]
                        and c.cost["hbm_bytes"] <= default_cand.cost["hbm_bytes"]] or [default_cand]
            best = min(pool, key=lambda c: _flops_bytes(c.cost)).config
        else:
            if guard_default:
                pool = [c for c in evaluated if c.time_us <= default_cand.time_us] or [default_cand]
            best = min(pool, key=lambda c: (c.time_us, *_flops_bytes(c.cost))).config

    _dispatch.record(kernel, canon, best, dtype, backend=backend)
    if persist:
        best_cand = next(c for c in evaluated if c.config == best)
        cost_rec = dict(best_cand.cost)
        if best_cand.time_us is not None:
            cost_rec["time_us"] = best_cand.time_us
        _cache.store(kernel, canon, dtype_s, backend, best, source=mode, cost=cost_rec)
    return TuneResult(
        kernel=kernel,
        shape=canon,
        dtype=dtype_s,
        backend=backend,
        mode=mode,
        best=dict(best),
        default=default,
        candidates=evaluated,
    )
