"""The serving services: batcher + engine + probe + liveness in one object
(port of ``EmbeddingService`` and ``LMService`` from
``repro/serve/service.py``).

The dispatch loop pops a coalesced batch from the ``MicroBatcher``,
pad-and-encodes it through the ``ServeEngine``, fans the rows back out to
the request futures, streams the batch into the ``DecorrProbe`` and beats
the heartbeat — on a background thread (``start`` / ``stop``) or
synchronously (``run_pending``, what tests drive).  ``metrics()`` is the
flat-gauge scrape surface; the reference's telemetry bundle (``repro.obs``:
tracing, registry, alerts) belongs to a later slice, so request latency
comes from ``ServeFuture.latency_s``.

``LMService`` ticks a ``ContinuousLMEngine`` at decode-step granularity:
admit queued prompts into freed slots, one batched decode over the pool,
retire finished requests — feeding the in-flight hidden rows to the probe.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.decorr.probe import slot_probe_rows
from repro_torch.ft.watchdog import HeartbeatMonitor
from repro_torch.kernels.utils import next_multiple
from repro_torch.serve.batcher import MicroBatcher, Request, ServeFuture
from repro_torch.serve.buckets import SUBLANE, BucketPolicy, bucket_sizes
from repro_torch.serve.engine import ContinuousLMEngine, ServeEngine
from repro_torch.serve.probes import DecorrProbe
from repro_torch.serve.slots import LMRequest

HEARTBEAT_NAME = "serve.dispatch"
HEARTBEAT_LM = "serve.lm_decode"


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


# ---------------------------------------------------------------------------
# Continuous-batching LM service
# ---------------------------------------------------------------------------


class LMService:
    """Continuous-batching LM serving over a ``ContinuousLMEngine``.

    Shares the embedding path's machinery: the bounded ``MicroBatcher`` owns
    admission and ``Backpressure``, the ``HeartbeatMonitor`` liveness (one
    beat per decode tick, idle included), ``DecorrProbe`` streams the
    in-flight slots' hidden rows, and ``metrics()`` exports the flat gauge
    dict — plus slot occupancy, time-to-first-token percentiles and, paged,
    the pool's page gauges.  ``step`` / ``drain`` are the synchronous entry
    points (tests, the closed-loop load); ``start`` / ``stop`` run the same
    tick on a background thread.  The reference's telemetry bundle and the
    speculative tick belong to later slices.
    """

    def __init__(
        self,
        engine: ContinuousLMEngine,
        *,
        max_queue: int = 1024,
        probe: Optional[DecorrProbe] = None,
        heartbeat: Optional[HeartbeatMonitor] = None,
        heartbeat_timeout_s: float = 10.0,
        record_probe_rows: bool = False,
    ):
        self.engine = engine
        n_slots = engine.pool.n_slots
        self.batcher = MicroBatcher(BucketPolicy(max_batch=n_slots, max_wait_ms=0.0, max_queue=max_queue))
        self.probe = probe
        if probe is not None and probe.sample_rows is None:
            # fixed probe window: at least one full pool of slot rows
            probe.sample_rows = max(next_multiple(n_slots, SUBLANE), SUBLANE)
        self.stats = LatencyStats()
        self._ttft = collections.deque(maxlen=4096)
        self.tokens_total = 0
        self._t0 = time.perf_counter()
        self.heartbeat = heartbeat or HeartbeatMonitor()
        self.heartbeat.register(HEARTBEAT_LM, heartbeat_timeout_s)
        self._thread: Optional[threading.Thread] = None
        self._errors = 0
        # head-of-line buffer for paged admission: requests whose page
        # reservation does not fit yet wait here in FIFO order (deferred,
        # never dropped or reordered past)
        self._pending: List[Request] = []
        # keep the exact rows fed to the probe, in order (host copies), so a
        # probe reading can be replayed offline (``loadgen.lm_probe_oracle_err``)
        self.record_probe_rows = record_probe_rows
        self.probe_rows: List[np.ndarray] = []

    # -- request side -------------------------------------------------------

    def submit(
        self,
        tokens,
        max_new_tokens: int,
        *,
        eos_id: Optional[int] = None,
        block: bool = False,
        timeout: Optional[float] = None,
    ) -> ServeFuture:
        """Queue one greedy generation request.  Raises ``ValueError`` at
        once for unservable requests (empty prompt, prompt beyond the largest
        bucket, cache or page-pool overflow) — reject, never hang — and
        ``Backpressure`` when the queue is at ``max_queue``."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 1:
            raise ValueError(f"prompt must be a 1-D token id array, got shape {tokens.shape}")
        self.engine.validate_request(int(tokens.shape[0]), int(max_new_tokens))
        req = LMRequest(tokens=tokens, max_new_tokens=int(max_new_tokens), eos_id=eos_id)
        return self.batcher.submit(req, block=block, timeout=timeout)

    # -- decode-step tick ---------------------------------------------------

    def _feed_probe(self, rows):
        if rows.shape[0] == 0:
            return
        if self.record_probe_rows:
            self.probe_rows.append(rows.detach().cpu().numpy() if torch.is_tensor(rows) else np.asarray(rows))
        if self.probe is not None:
            self.probe.observe(rows)

    def _finish(self, slot):
        slot.future.set_result(np.asarray(slot.emitted, np.int32))
        self.tokens_total += len(slot.emitted)
        self.stats.observe_batch([slot.future.latency_s])
        self.engine.release(slot.index)

    def _fail(self, future, exc):
        self._errors += 1
        future.set_exception(exc)

    def _emit_first(self, slot, token: int, hidden_row):
        """After a prefill: TTFT, probe feed, first-token emit, possible
        immediate retirement."""
        slot.future.t_first = time.perf_counter()
        self._ttft.append(slot.future.ttft_s)
        self._feed_probe(hidden_row.float())
        if slot.emit(token):
            self._finish(self.engine.pool.retire(slot.index))

    def step(self, timeout: float = 0.0) -> Optional[int]:
        """One scheduler tick: admit into freed slots (deferring requests
        whose page reservation does not fit yet), decode the pool once,
        retire finished requests.  Returns in-flight work after the tick, or
        None once ``shutdown`` has been signalled and everything drained."""
        pool = self.engine.pool
        want = max(pool.free_slots() - len(self._pending), 0)
        reqs = self.batcher.next_requests(want, timeout=timeout)
        shutting_down = reqs is None
        self._pending.extend(reqs or [])
        while self._pending and pool.free_slots():
            if not self.engine.can_admit(self._pending[0].x):
                break  # FIFO: later arrivals must not starve the head
            r = self._pending.pop(0)
            slot = pool.admit(r.x, r.future)
            self.engine.admit_slot(slot)
            try:
                token, hidden_row = self.engine.insert(slot)
            except Exception as e:  # device failure path
                self.engine.abort_slot(slot.index)
                pool.retire(slot.index)
                self._fail(r.future, e)
                continue
            self._emit_first(slot, token, hidden_row)
        active = pool.active_indices()
        if active:
            try:
                next_tok, hidden = self.engine.decode_step()
            except Exception as e:  # device failure path
                for i in pool.active_indices():
                    self.engine.abort_slot(i)
                    self._fail(pool.retire(i).future, e)
            else:
                # occupancy counts the lanes that decoded this step
                # (retirement happens after), matching the probe's row feed
                pool.observe_step()
                self._feed_probe(slot_probe_rows(hidden, active))
                for i in active:
                    if pool[i].emit(next_tok[i]):
                        self._finish(pool.retire(i))
        self.heartbeat.beat(HEARTBEAT_LM)
        if shutting_down and not pool.active() and not self._pending:
            return None
        return len(self._pending) + len(pool.active())

    def drain(self, max_steps: int = 1_000_000) -> int:
        """Tick until the queue and the pool are empty; returns ticks run."""
        ran = 0
        while ran < max_steps and (self.batcher.depth() or self._pending or self.engine.pool.active()):
            self.step(timeout=0.0)
            ran += 1
        return ran

    def _loop(self):
        while True:
            if self.step(timeout=0.05) is None:
                return

    def warmup(self) -> "LMService":
        """Run every prompt bucket, the pool decode step and the probe window
        once (this builds the CUDA kernels), so no request pays a first call."""
        self.engine.warmup()
        if self.probe is not None:
            self.probe.warmup(self.engine.cfg.d_model)
        self.stats.reset_clock()
        self._t0 = time.perf_counter()
        return self

    def start(self) -> "LMService":
        """Run the decode-tick loop on a daemon thread; returns self."""
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._thread = threading.Thread(target=self._loop, name="serve-lm-decode", daemon=True)
        self.stats.reset_clock()
        self._t0 = time.perf_counter()
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0):
        """Stop the tick thread (in-flight requests keep their state)."""
        if self._thread is None:
            return
        self.batcher.shutdown()
        self._thread.join(timeout)
        self._thread = None

    # -- scrape surface -----------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        """The LM service's flat-gauge scrape surface."""
        dt = max(time.perf_counter() - self._t0, 1e-9)
        ttft = np.asarray(self._ttft) if self._ttft else np.zeros((1,))
        own = {
            "queue_depth": float(self.batcher.depth()),
            "dispatch_errors": float(self._errors),
            "tokens_total": float(self.tokens_total),
            "tok_per_s": self.tokens_total / dt,
            "ttft_p50_ms": float(np.percentile(ttft, 50) * 1e3),
            "ttft_p99_ms": float(np.percentile(ttft, 99) * 1e3),
        }
        paged = None
        if self.engine.paged:
            paged = dict(self.engine.pager.metrics(), admission_deferred=float(len(self._pending)))
        return collect_metrics(own, self.engine.pool, paged, self.stats, self.heartbeat, self.probe)
