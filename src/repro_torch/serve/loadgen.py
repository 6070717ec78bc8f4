"""Load generation + policy comparison for the embedding path (port of the
embedding part of ``repro/serve/loadgen.py``).

Deterministic synthetic traffic (seeded inputs, seeded exponential
inter-arrivals — numpy, so the port and the reference see the same rows)
driven through two serving policies:

  * ``naive``       — one engine call per request, no coalescing;
  * ``microbatch``  — requests submitted to the ``EmbeddingService`` and
    coalesced by the admission policy into bucketed batches.

Both report per-request p50/p99 latency and sustained throughput.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.serve.buckets import BucketPolicy
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.service import EmbeddingService


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """Closed-loop embedding workload knobs (deterministic by seed)."""

    n_requests: int = 256
    input_dim: int = 64
    arrival_rps: Optional[float] = None  # None = closed-loop burst (max load)
    seed: int = 0


def request_stream(cfg: LoadConfig):
    """Deterministic (inputs, inter-arrival gaps) for one load run."""
    rng = np.random.default_rng(cfg.seed)
    xs = rng.standard_normal((cfg.n_requests, cfg.input_dim)).astype(np.float32)
    if cfg.arrival_rps:
        gaps = rng.exponential(1.0 / cfg.arrival_rps, cfg.n_requests)
    else:
        gaps = np.zeros(cfg.n_requests)
    return xs, gaps


def _summary(latencies_s: List[float], wall_s: float) -> Dict[str, float]:
    lat = np.asarray(latencies_s)
    return {
        "requests": float(len(lat)),
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "throughput_rps": len(lat) / max(wall_s, 1e-9),
        "wall_s": wall_s,
    }


def _sync(z: torch.Tensor) -> None:
    if z.is_cuda:
        torch.cuda.synchronize(z.device)


def run_naive(engine: ServeEngine, load: LoadConfig) -> Dict[str, float]:
    """Per-request serving: every request is its own (bucket-1) dispatch."""
    xs, gaps = request_stream(load)
    _sync(engine.encode(xs[0]))  # first call outside the timed run
    lat: List[float] = []
    t_run = time.perf_counter()
    for i in range(load.n_requests):
        if gaps[i]:
            time.sleep(gaps[i])
        t0 = time.perf_counter()
        _sync(engine.encode(xs[i]))
        lat.append(time.perf_counter() - t0)
    return _summary(lat, time.perf_counter() - t_run)


def run_microbatched(
    service: EmbeddingService, load: LoadConfig, timeout_s: float = 120.0
) -> Dict[str, float]:
    """Open-loop submission into the started service's dispatch thread.

    The results (one (d,) row per request, in request order) are returned
    under ``"rows"`` for callers that check them.
    """
    xs, gaps = request_stream(load)
    service.warmup()
    futures = []
    t_run = time.perf_counter()
    for i in range(load.n_requests):
        if gaps[i]:
            time.sleep(gaps[i])
        futures.append(service.submit(xs[i], block=True, timeout=timeout_s))
    results = [f.result(timeout=timeout_s) for f in futures]
    wall = time.perf_counter() - t_run
    if any(r.shape != (service.engine.d,) for r in results):
        raise RuntimeError("a served embedding has the wrong shape")
    out = _summary([f.latency_s for f in futures], wall)
    out["mean_batch"] = service.stats.served / max(service.stats.batches, 1)
    out["batches"] = float(service.stats.batches)
    out["rows"] = np.stack(results)
    return out


def compare_policies(
    engine_fn,
    load: LoadConfig,
    policy: BucketPolicy,
    probe_fn=None,
) -> Dict[str, Dict[str, float]]:
    """Run naive then micro-batched on fresh engines.  ``engine_fn() ->
    ServeEngine``; ``probe_fn() -> DecorrProbe`` (optional; the
    micro-batched run feeds it every dispatched batch)."""
    naive = run_naive(engine_fn(), load)
    probe = probe_fn() if probe_fn is not None else None
    service = EmbeddingService(engine_fn(), policy=policy, probe=probe).start()
    try:
        micro = run_microbatched(service, load)
        metrics = service.metrics()
    finally:
        service.stop()
    out = {"naive": naive, "microbatch": micro, "service_metrics": metrics}
    out["gate"] = {
        "microbatch_beats_naive": micro["throughput_rps"] >= naive["throughput_rps"],
        "speedup": micro["throughput_rps"] / max(naive["throughput_rps"], 1e-9),
    }
    return out
