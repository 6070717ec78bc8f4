"""The embedding service: batcher + engine + probe + liveness in one object
(port of ``EmbeddingService`` from ``repro/serve/service.py``).

The dispatch loop pops a coalesced batch from the ``MicroBatcher``,
pad-and-encodes it through the ``ServeEngine``, fans the rows back out to
the request futures, streams the batch into the ``DecorrProbe`` and beats
the heartbeat — on a background thread (``start`` / ``stop``) or
synchronously (``run_pending``, what tests drive).  ``metrics()`` is the
flat-gauge scrape surface; the reference's telemetry bundle (``repro.obs``:
tracing, registry, alerts) belongs to a later slice, so request latency
comes from ``ServeFuture.latency_s``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Mapping, Optional

import numpy as np

from repro_torch.ft.watchdog import HeartbeatMonitor
from repro_torch.serve.batcher import MicroBatcher, Request, ServeFuture
from repro_torch.serve.buckets import BucketPolicy, bucket_sizes
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.probes import DecorrProbe

HEARTBEAT_NAME = "serve.dispatch"


def collect_metrics(*parts) -> Dict[str, float]:
    """Merge metric sources (flat dicts or objects with ``.metrics()``)."""
    out: Dict[str, float] = {}
    for part in parts:
        if part is not None:
            out.update(part if isinstance(part, Mapping) else part.metrics())
    return out


class LatencyStats:
    """Rolling per-request latency window + monotone served counter."""

    def __init__(self, window: int = 4096):
        self._lat = collections.deque(maxlen=window)
        self.served = 0
        self.batches = 0
        self._t_start = time.perf_counter()

    def reset_clock(self):
        """Restart the throughput window (when serving actually starts)."""
        self._t_start = time.perf_counter()

    def observe_batch(self, latencies_s: List[float]):
        """Fold one dispatched batch's per-request latencies in."""
        self._lat.extend(latencies_s)
        self.served += len(latencies_s)
        self.batches += 1

    def percentile(self, q: float) -> float:
        """Latency percentile (seconds) over the rolling window."""
        if not self._lat:
            return 0.0
        return float(np.percentile(np.asarray(self._lat), q))

    def metrics(self, prefix: str = "latency_") -> Dict[str, float]:
        """Flat latency/throughput gauges for the scrape surface."""
        dt = max(time.perf_counter() - self._t_start, 1e-9)
        return {
            f"{prefix}p50_ms": self.percentile(50) * 1e3,
            f"{prefix}p99_ms": self.percentile(99) * 1e3,
            "served_total": float(self.served),
            "batches_total": float(self.batches),
            "mean_batch": self.served / max(self.batches, 1),
            "throughput_rps": self.served / dt,
        }


class EmbeddingService:
    """Batched embedding serving with online representation-health probes."""

    def __init__(
        self,
        engine: ServeEngine,
        *,
        policy: Optional[BucketPolicy] = None,
        probe: Optional[DecorrProbe] = None,
        heartbeat: Optional[HeartbeatMonitor] = None,
        heartbeat_timeout_s: float = 10.0,
    ):
        self.engine = engine
        self.policy = (policy or engine.policy).validate()
        self.batcher = MicroBatcher(self.policy)
        self.probe = probe
        if probe is not None and probe.sample_rows is None:
            # pin the probe to one window shape: the largest bucket
            probe.sample_rows = bucket_sizes(self.policy)[-1]
        self.stats = LatencyStats()
        self.heartbeat = heartbeat or HeartbeatMonitor()
        self.heartbeat.register(HEARTBEAT_NAME, heartbeat_timeout_s)
        self._thread: Optional[threading.Thread] = None
        self._errors = 0

    # -- request side -------------------------------------------------------

    def submit(self, x, **kw) -> ServeFuture:
        """Queue one request (a single input row or a small row-batch).
        Rejects empty/malformed inputs with ``ValueError``; raises
        ``repro_torch.serve.batcher.Backpressure`` when the queue is full."""
        x = np.asarray(x)
        if x.ndim not in (1, 2):
            raise ValueError(f"expected a (d,) row or (n, d) row-batch, got shape {x.shape}")
        if x.size == 0:
            raise ValueError(f"empty request (shape {x.shape}); nothing to embed")
        return self.batcher.submit(x, **kw)

    # -- dispatch loop ------------------------------------------------------

    def _dispatch(self, requests: List[Request]):
        rows = [r.x if r.x.ndim == 2 else r.x[None] for r in requests]
        x = np.concatenate(rows, axis=0)
        try:
            z = self.engine.encode(x)
            # one device->host copy (it also waits for the device); numpy
            # fan-out below avoids a device slice per request
            z_host = z.cpu().numpy()
        except Exception as e:  # device failure path: fail the batch's futures
            self._errors += 1
            for r in requests:
                r.future.set_exception(e)
            return
        if self.probe is not None:
            self.probe.observe(z)
        off = 0
        latencies = []
        for r in requests:
            n = r.x.shape[0] if r.x.ndim == 2 else 1
            r.future.set_result(z_host[off] if r.x.ndim == 1 else z_host[off : off + n])
            off += n
            latencies.append(r.future.latency_s)
        self.stats.observe_batch(latencies)
        self.heartbeat.beat(HEARTBEAT_NAME)

    def run_pending(self, timeout: float = 0.0) -> int:
        """Synchronously serve one admission batch; returns requests served."""
        batch = self.batcher.next_batch(timeout=timeout)
        if not batch:
            return 0
        self._dispatch(batch)
        return len(batch)

    def _loop(self):
        while True:
            batch = self.batcher.next_batch(timeout=0.05)
            if batch is None:  # shutdown
                return
            if batch:
                self._dispatch(batch)
            else:
                # an idle tick still beats: staleness must mean a wedged
                # loop, not an empty queue
                self.heartbeat.beat(HEARTBEAT_NAME)

    def warmup(self) -> "EmbeddingService":
        """Run every engine bucket and the probe window once (this builds
        the CUDA kernels), so no request waits on a first call."""
        self.engine.warmup()
        if self.probe is not None:
            self.probe.warmup(self.engine.d)
        self.stats.reset_clock()
        return self

    def start(self) -> "EmbeddingService":
        """Run the dispatch loop on a daemon thread; returns self."""
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._thread = threading.Thread(target=self._loop, name="serve-dispatch", daemon=True)
        self.stats.reset_clock()
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        """Shut the dispatch thread down (drain, then join)."""
        if self._thread is None:
            return
        self.batcher.shutdown()
        self._thread.join(timeout)
        self._thread = None

    # -- scrape surface -----------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        """The embedding service's flat-gauge scrape surface."""
        return collect_metrics(
            {
                "queue_depth": float(self.batcher.depth()),
                "dispatch_errors": float(self._errors),
                "compiled_buckets": float(len(self.engine.compiled_buckets())),
            },
            self.stats,
            self.heartbeat,
            self.probe,
        )
