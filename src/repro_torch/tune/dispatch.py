"""Config dispatch: the one place call sites get a tuned choice from (port
of ``repro/tune/dispatch.py``).

``best_config(kernel, shape)`` resolves, in precedence order:

  1. an explicit override installed with ``override(...)`` / ``set_override``
     (tests and the tuner's measured tier pin configs without touching the
     cache),
  2. the in-process memo (one search per (kernel, shape, dtype, backend)
     per process — a cache hit never re-searches),
  3. the persistent JSON cache (written by ``python -m repro_torch.tune`` or
     ``tuner.tune(persist=True)``),
  4. a deterministic analytic search over ``space.candidates`` ranked by
     ``cost.analytic_cost`` (instant; memoized but not persisted, so the
     on-disk cache only ever holds deliberately tuned entries).

Shapes are keys as given (``canonical_shape``): the plans and the page are
semantic, and a Hopper C entry fixes its tile from the exact sizes.  The
call sites resolve at call time, every call, so an override or a new
cache entry reaches the next call.

``best_impl(op, device)`` states the port's route rule: the hand-written
kernels on a CUDA device, the plain PyTorch route on the CPU, an
``override(op, impl=...)`` winning over both.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.tune import cache as _cache
from repro_torch.tune import cost as _cost
from repro_torch.tune import space as _space

Config = Dict[str, int]

_lock = threading.Lock()
_MEMO: Dict[Tuple, Config] = {}
_OVERRIDES: Dict[str, list] = {}
_IMPLS = ("kernel", "plain")


def canonical_shape(kernel: str, shape) -> Tuple[int, ...]:
    """The shape used as cache key: the shape itself, as ints (checked
    against the kernel's rank)."""
    if kernel not in _space.KERNELS:
        raise KeyError(kernel)
    rank = {"sumvec_fft_plan": 1, "freq_mat": 4, "paged_attention": 4, "cmatmul": 3, "pmatmul": 3,
            "freq_outer": 3}.get(kernel, 2)
    if len(shape) != rank:
        raise ValueError(f"{kernel} takes a shape of {rank} sizes, got {tuple(shape)}")
    return tuple(int(s) for s in shape)


def dtype_str(dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the reference's dtype names)."""
    return str(dtype).replace("torch.", "")


def _analytic_search(kernel: str, shape: Tuple[int, ...]) -> Config:
    cands = _space.candidates(kernel, shape)
    if not cands:
        return _space.default_config(kernel, shape)
    return min(cands, key=lambda c: _cost.rank_key(_cost.analytic_cost(kernel, shape, c), kernel))


def _complete_plan_override(params: Config, merged: Config, d: int) -> Config:
    """A partial four-step override completed against the default: plan keys
    are jointly constrained (dp == d1 * d2, dp == d or dp >= 2d - 1), so an
    unsatisfiable one raises here with a message rather than deep in
    ``FFTPlan``."""
    has_d1, has_d2 = "d1" in params, "d2" in params
    if has_d1 and has_d2:
        if "dp" in params and params["dp"] != params["d1"] * params["d2"]:
            raise ValueError(f"sumvec_fft_plan override {params}: dp != d1 * d2")
        merged["dp"] = merged["d1"] * merged["d2"]
    elif has_d1 or has_d2:
        # one factor pinned: complete against the (possibly also pinned) dp
        given = params["d1"] if has_d1 else params["d2"]
        if given <= 0 or merged["dp"] % given:
            raise ValueError(f"sumvec_fft_plan override {params} does not divide dp={merged['dp']}")
        other = merged["dp"] // given
        merged["d1"], merged["d2"] = (given, other) if has_d1 else (other, given)
    elif "dp" in params:
        merged["d1"], merged["d2"] = _space.balanced_factors(merged["dp"])
    if not _space.is_legal("sumvec_fft_plan", (d,), merged):
        raise ValueError(f"sumvec_fft_plan override {params} is inconsistent at d={d}: {merged}")
    return merged


def best_config(kernel: str, shape, dtype=torch.float32, *, backend: Optional[str] = None) -> Config:
    """The config a call site uses: override > memo > disk cache > analytic."""
    with _lock:
        stack = _OVERRIDES.get(kernel)
        params = dict(stack[-1]) if stack else None
    canon = canonical_shape(kernel, shape)
    if params is not None:
        merged = {**_space.default_config(kernel, canon), **params}
        if kernel == "sumvec_fft_plan":
            merged = _complete_plan_override(params, merged, canon[0])
        return merged
    backend = backend or _cache.backend_key()
    key = (kernel, canon, dtype_str(dtype), backend)
    with _lock:
        hit = _MEMO.get(key)
    if hit is not None:
        return dict(hit)
    entry = _cache.lookup(kernel, canon, dtype_str(dtype), backend)
    try:
        legal = entry is not None and _space.is_legal(kernel, canon, entry["config"])
    except (KeyError, TypeError):
        legal = False  # a config with missing or renamed keys is a miss
    cfg = entry["config"] if legal else _analytic_search(kernel, canon)
    with _lock:
        _MEMO[key] = dict(cfg)
    return dict(cfg)


def best_impl(op: str, device) -> str:
    """``"kernel"`` for a CUDA device, ``"plain"`` for the CPU; an
    ``override(op, impl=...)`` wins over both."""
    with _lock:
        stack = _OVERRIDES.get(op)
        pinned = stack[-1].get("impl") if stack else None
    if pinned is not None:
        if pinned not in _IMPLS:
            raise ValueError(f"override({op!r}, impl={pinned!r}): impl must be one of {_IMPLS}")
        return str(pinned)
    return "kernel" if torch.device(device).type == "cuda" else "plain"


# ---------------------------------------------------------------------------
# Overrides + cache control
# ---------------------------------------------------------------------------


def set_override(kernel: str, **params) -> None:
    with _lock:
        _OVERRIDES.setdefault(kernel, []).append(dict(params))


def clear_override(kernel: str) -> None:
    with _lock:
        stack = _OVERRIDES.get(kernel)
        if stack:
            stack.pop()
        if not stack:
            _OVERRIDES.pop(kernel, None)


@contextlib.contextmanager
def override(kernel: str, **params):
    """Pin (part of) a kernel's config, or an op's ``impl``; beats every
    cache tier while active."""
    set_override(kernel, **params)
    try:
        yield
    finally:
        clear_override(kernel)


def clear_memory_cache() -> None:
    with _lock:
        _MEMO.clear()


def record(kernel: str, shape, config: Config, dtype=torch.float32, *, backend: Optional[str] = None) -> None:
    """Install a searched config into the in-process memo (tuner hook)."""
    key = (kernel, canonical_shape(kernel, shape), dtype_str(dtype), backend or _cache.backend_key())
    with _lock:
        _MEMO[key] = dict(config)
