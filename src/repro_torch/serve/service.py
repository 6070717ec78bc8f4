"""The serving services: batcher + engine + probe + liveness in one object
(port of ``EmbeddingService`` and ``LMService`` from
``repro/serve/service.py``).

The dispatch loop pops a coalesced batch from the ``MicroBatcher``,
pad-and-encodes it through the ``ServeEngine``, fans the rows back out to
the request futures, streams the batch into the ``DecorrProbe`` and beats
the heartbeat — on a background thread (``start`` / ``stop``) or
synchronously (``run_pending``, what tests drive).  ``metrics()`` is the
flat-gauge scrape surface, mirrored into the ``repro_torch.obs`` registry
of the service's ``Obs`` bundle (default: fully enabled; ``Obs.disabled()``
turns spans, flight recording, histograms and executable timing off).  A
request's ``RequestTrace`` (``future.trace``) is its timing source.

``LMService`` ticks a ``ContinuousLMEngine`` at decode-step granularity:
admit queued prompts into freed slots, advance at most one chunk of a
chunked prefill, one batched decode (or speculative verify) over the pool,
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
from repro_torch.obs import Obs
from repro_torch.serve.batcher import Backpressure, MicroBatcher, Request, ServeFuture
from repro_torch.serve.buckets import SUBLANE, BucketPolicy, bucket_sizes
from repro_torch.serve.engine import ContinuousLMEngine, ServeEngine
from repro_torch.serve.probes import DecorrProbe
from repro_torch.serve.sampling import SamplingParams, sample_token
from repro_torch.serve.slots import LMRequest
from repro_torch.serve.spec import SpecStats, accept_length, draft_budget

HEARTBEAT_NAME = "serve.dispatch"
HEARTBEAT_LM = "serve.lm_decode"


def collect_metrics(*parts, registry=None) -> Dict[str, float]:
    """Merge metric sources (flat dicts or objects with ``.metrics()``) into
    one scrape dict, optionally mirroring every key into a registry as
    gauges, so the flat dict and the registry view cannot drift.  A part
    with ``publish_metrics(registry) -> set`` (the ``HeartbeatMonitor``)
    publishes its own labelled family and returns the flat keys it claims:
    those stay in the returned dict but are not published flat."""
    out: Dict[str, float] = {}
    claimed: set = set()
    for part in parts:
        if part is None:
            continue
        out.update(part if isinstance(part, Mapping) else part.metrics())
        if registry is not None and hasattr(part, "publish_metrics"):
            claimed |= part.publish_metrics(registry)
    if registry is not None:
        registry.publish({k: v for k, v in out.items() if k not in claimed})
    return out


def _trace_of(future) -> Optional["object"]:
    return getattr(future, "trace", None)


class _ObsAPI:
    """Telemetry surface shared by both services (``self.obs`` is the
    ``repro_torch.obs.Obs`` bundle set in the subclass ``__init__``)."""

    obs: Obs

    def start_metrics_server(self, port: int = 0, host: str = "127.0.0.1"):
        """Expose this service's scrape surface over HTTP (``/metrics``,
        ``/alerts``, ``/perf``, ``/flight``, ``/healthz``); returns the
        started server."""
        return self.obs.start_server(port=port, metrics_fn=self.metrics, host=host)

    def scrape(self) -> str:
        """One Prometheus exposition of this service (also evaluates the
        alert rules)."""
        return self.obs.scrape(self.metrics)

    def start_profiling(self, trace_dir: Optional[str] = None) -> bool:
        return self.obs.profiler.start(trace_dir)

    def stop_profiling(self) -> Optional[str]:
        return self.obs.profiler.stop()


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


class EmbeddingService(_ObsAPI):
    """Batched embedding serving with online representation-health probes."""

    def __init__(
        self,
        engine: ServeEngine,
        *,
        policy: Optional[BucketPolicy] = None,
        probe: Optional[DecorrProbe] = None,
        heartbeat: Optional[HeartbeatMonitor] = None,
        heartbeat_timeout_s: float = 10.0,
        obs: Optional[Obs] = None,
    ):
        self.engine = engine
        self.obs = obs or Obs()
        # executable timing stays off (perf = None) when telemetry is
        # disabled, so the hot path never waits on the device for it
        engine.perf = self.obs.perf if self.obs.perf.enabled else None
        self._h_encode = self.obs.registry.histogram("serve_encode_seconds", "embedding batch encode wall time")
        self.policy = (policy or engine.policy).validate()
        self.batcher = MicroBatcher(self.policy)
        self.probe = probe
        if probe is not None:
            probe.perf = engine.perf
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
        tr = self.obs.tracer.start_request("embed", rows=int(x.shape[0] if x.ndim == 2 else 1))
        try:
            fut = self.batcher.submit(x, **kw)
        except Backpressure:
            self.obs.recorder.record("backpressure", traffic="embed", queue_depth=self.batcher.depth())
            raise
        fut.trace = tr
        return fut

    # -- dispatch loop ------------------------------------------------------

    def _dispatch(self, requests: List[Request]):
        depth = self.batcher.depth()
        for r in requests:
            tr = _trace_of(r.future)
            if tr is not None:
                tr.mark_admit(batch=len(requests), queue_depth=depth)
        rows = [r.x if r.x.ndim == 2 else r.x[None] for r in requests]
        x = np.concatenate(rows, axis=0)
        t0 = time.perf_counter()
        try:
            z = self.engine.encode(x)
            # one device->host copy (it also waits for the device); numpy
            # fan-out below avoids a device slice per request
            z_host = z.cpu().numpy()
        except Exception as e:  # device failure path: fail the batch's futures
            self._errors += 1
            for r in requests:
                r.future.set_exception(e)
                tr = _trace_of(r.future)
                if tr is not None:
                    tr.mark_done("error")
            self.obs.recorder.record("error", traffic="embed", batch=len(requests))
            return
        t1 = time.perf_counter()
        if self.obs.enabled:
            self._h_encode.observe(t1 - t0)
            self.obs.tracer.add_span("encode", t0, t1, cat="exec", rows=int(x.shape[0]))
        self.obs.recorder.record("dispatch", requests=len(requests), rows=int(x.shape[0]), queue_depth=depth)
        if self.probe is not None:
            self.probe.observe(z)
        off = 0
        latencies = []
        for r in requests:
            n = r.x.shape[0] if r.x.ndim == 2 else 1
            r.future.set_result(z_host[off] if r.x.ndim == 1 else z_host[off : off + n])
            off += n
            tr = _trace_of(r.future)
            if tr is not None:
                tr.mark_done()
                latencies.append(tr.latency_s)
            else:
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
            self.obs,
            registry=self.obs.registry,
        )


# ---------------------------------------------------------------------------
# Continuous-batching LM service
# ---------------------------------------------------------------------------


class LMService(_ObsAPI):
    """Continuous-batching LM serving over a ``ContinuousLMEngine``.

    Shares the embedding path's machinery: the bounded ``MicroBatcher`` owns
    admission and ``Backpressure``, the ``HeartbeatMonitor`` liveness (one
    beat per decode tick, idle included), ``DecorrProbe`` streams the
    in-flight slots' hidden rows, and ``metrics()`` exports the flat gauge
    dict — plus slot occupancy, time-to-first-token percentiles and, paged,
    the pool's page gauges (and the speculation counters).  ``step`` /
    ``drain`` are the synchronous entry points (tests, the closed-loop
    load); ``start`` / ``stop`` run the same tick on a background thread.
    ``obs`` (default: an enabled ``Obs``) gets the tick's spans, step-time
    histograms, flight-recorder events and executable timing.
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
        obs: Optional[Obs] = None,
    ):
        self.engine = engine
        self.obs = obs or Obs()
        # the engine narrates page-table activity into the same ring buffer
        engine.recorder = self.obs.recorder
        # executable timing stays off (perf = None) when telemetry is
        # disabled, so the decode tick never waits on the device for it
        engine.perf = self.obs.perf if self.obs.perf.enabled else None
        if probe is not None:
            probe.perf = engine.perf
        reg = self.obs.registry
        self._h_prefill = reg.histogram("serve_prefill_seconds", "whole-prompt insert wall time")
        self._h_chunk = reg.histogram("serve_chunk_prefill_seconds", "one chunked-prefill step wall time")
        self._h_decode = reg.histogram("serve_decode_step_seconds", "one batched decode step wall time")
        # the TTFT source of record for alerting: the scrape path derives
        # serve_ttft_seconds_p50 / _p99 gauges from its buckets
        self._h_ttft = reg.histogram("serve_ttft_seconds", "time to first token (queue + prefill)")
        self._h_verify = reg.histogram(
            "serve_verify_step_seconds", "one lane-batched speculative verify forward wall time")
        # speculation counters (zero unless the engine is speculative)
        self.spec_stats = SpecStats()
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
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        seed: Optional[int] = None,
        block: bool = False,
        timeout: Optional[float] = None,
    ) -> ServeFuture:
        """Queue one generation request.  Raises ``ValueError`` at once for
        unservable requests (empty prompt, prompt beyond the largest bucket,
        cache or page-pool overflow, sampling on a greedy-only engine) —
        reject, never hang — and ``Backpressure`` when the queue is at
        ``max_queue``.  ``temperature`` / ``top_k`` / ``seed`` select
        per-request sampled decoding (temperature 0 = greedy, identical to
        the argmax path)."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 1:
            raise ValueError(f"prompt must be a 1-D token id array, got shape {tokens.shape}")
        self.engine.validate_request(int(tokens.shape[0]), int(max_new_tokens))
        sampling = None
        if temperature or top_k or seed is not None:
            sampling = SamplingParams(temperature=float(temperature), top_k=top_k, seed=seed).validate()
            if not sampling.greedy and not self.engine.sampling_enabled:
                raise ValueError(
                    "temperature > 0 needs an engine built with sampling=True "
                    "(the greedy engine keeps its argmax on the device)"
                )
        req = LMRequest(tokens=tokens, max_new_tokens=int(max_new_tokens), eos_id=eos_id, sampling=sampling)
        tr = self.obs.tracer.start_request("lm", prompt_len=int(tokens.shape[0]), max_new_tokens=int(max_new_tokens))
        try:
            fut = self.batcher.submit(req, block=block, timeout=timeout)
        except Backpressure:
            self.obs.recorder.record("backpressure", traffic="lm", queue_depth=self.batcher.depth())
            raise
        fut.trace = tr
        return fut

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
        tr = _trace_of(slot.future)
        if tr is not None:
            tr.mark_done()
        self.tokens_total += len(slot.emitted)
        self.stats.observe_batch([tr.latency_s if tr is not None else slot.future.latency_s])
        eos = slot.request.eos_id is not None and slot.emitted and slot.emitted[-1] == slot.request.eos_id
        self.obs.recorder.record("retire", slot=slot.index, tokens=len(slot.emitted),
                                 reason="eos" if eos else "budget")
        self.engine.release(slot.index)

    def _fail(self, future, exc):
        """Common error tail: reject the future, close its trace, log the
        anomaly to the flight recorder."""
        self._errors += 1
        future.set_exception(exc)
        tr = _trace_of(future)
        if tr is not None:
            tr.mark_done("error")
        self.obs.recorder.record("error", traffic="lm", error=type(exc).__name__)

    def _pick_token(self, slot, out) -> int:
        """``out``: a token id (greedy engine) or a (V,) logits row (sampling
        engine) — drawn with the request's own params and random stream."""
        if not self.engine.sampling_enabled:
            return int(out)
        return sample_token(out, slot.request.sampling, slot.rng)

    def _emit_first(self, slot, out, hidden_row):
        """Common tail of whole-prompt insert and final-chunk completion:
        TTFT, probe feed, first-token emit, possible immediate retirement."""
        slot.future.t_first = time.perf_counter()
        tr = _trace_of(slot.future)
        if tr is not None:
            tr.mark_first()
            ttft = tr.ttft_s
        else:
            ttft = slot.future.ttft_s
        self._ttft.append(ttft)
        if self.obs.enabled:
            self._h_ttft.observe(ttft)
        self._feed_probe(hidden_row.float())
        if slot.emit(self._pick_token(slot, out)):
            self._finish(self.engine.pool.retire(slot.index))

    def _spec_tick(self, active: List[int]) -> bool:
        """One speculative decode tick over the decoding slots.

        Drafts per slot (host-side n-gram lookup), then — when at least one
        slot drafted — ONE lane-batched verify for the whole pool (undrafted
        slots ride their plain lane 0), accepts the longest matching prefix
        per slot and emits the accepted span plus the model's bonus token.
        Returns False when no slot drafted: the caller runs the plain decode
        step (batch ``n_slots`` instead of ``n_slots * (k + 1)``)."""
        pool = self.engine.pool
        rec = self.obs.recorder
        stats = self.spec_stats
        perf = self.engine.perf
        t0 = perf.start() if perf is not None else 0.0
        drafts = []
        for i in active:
            s = pool[i]
            budget = draft_budget(self.engine.spec_cfg.draft_k, s.request.max_new_tokens, len(s.emitted))
            d = s.draft.propose(budget) if budget > 0 else []
            stats.drafts += 1
            if d:
                stats.draft_hits += 1
                rec.record("spec_draft", slot=i, k=len(d))
            drafts.append((i, d))
        if perf is not None:
            perf.observe("draft", perf.elapsed(t0))
        if not any(d for _, d in drafts):
            stats.plain_steps += 1
            return False
        t0 = time.perf_counter()
        out, hidden, tickets = self.engine.spec_verify(drafts)
        if self.obs.enabled:
            t1 = time.perf_counter()
            self._h_verify.observe(t1 - t0)
            self.obs.tracer.add_span("verify_step", t0, t1, cat="exec", lanes=len(active))
        stats.verify_steps += 1
        stats.slot_lanes += len(active)
        pool.observe_step()
        for i, d in drafts:
            s = pool[i]
            k_eff = len(d)
            lane_out = out[i]
            a = accept_length(d, lane_out[: k_eff + 1]) if k_eff else 0
            ticket = tickets.get(i)
            if ticket is not None:
                # commit ALWAYS: lane 0's write at pos is the one plain
                # decode would have made, even when the whole draft missed
                self.engine.spec_commit(ticket, a + 1)
            if k_eff:
                s.draft.observe_accept(a)
                stats.tokens_proposed += k_eff
                stats.tokens_accepted += a
                if a < k_eff:
                    stats.rejects += 1
                    rec.record("spec_reject", slot=i, k=k_eff, accepted=a)
                rec.record("spec_accept", slot=i, k=k_eff, accepted=a, emitted=a + 1)
            n_emitted = 0
            done = False
            tr = _trace_of(s.future)
            for j in range(a + 1):
                if tr is not None:
                    tr.tick()
                done = s.emit(self._pick_token(s, lane_out[j]))
                n_emitted += 1
                if done:
                    break
            stats.tokens_emitted += n_emitted
            stats.per_slot[i] = stats.per_slot.get(i, 0) + n_emitted
            # one hidden row per emitted token — the rows, in the per-slot
            # order, that sequential decode would have fed the probe
            self._feed_probe(hidden[i, :n_emitted].float())
            if done:
                self._finish(pool.retire(i))
        return True

    def step(self, timeout: float = 0.0) -> Optional[int]:
        """One scheduler tick: admit into freed slots (deferring requests
        whose page reservation does not fit yet), advance at most one chunk
        of a chunked prefill, decode the pool once (or run one speculative
        verify), retire finished requests.  Returns in-flight work after the
        tick, or None once ``shutdown`` has been signalled and everything
        drained."""
        pool = self.engine.pool
        rec = self.obs.recorder
        want = max(pool.free_slots() - len(self._pending), 0)
        reqs = self.batcher.next_requests(want, timeout=timeout)
        shutting_down = reqs is None
        self._pending.extend(reqs or [])
        while self._pending and pool.free_slots():
            if not self.engine.can_admit(self._pending[0].x):
                # FIFO: later arrivals must not starve the head
                rec.record("defer", prompt_len=self._pending[0].x.prompt_len, pending=len(self._pending))
                break
            r = self._pending.pop(0)
            slot = pool.admit(r.x, r.future)
            hit = self.engine.admit_slot(slot)
            tr = _trace_of(r.future)
            if tr is not None:
                tr.mark_admit(slot=slot.index, queue_depth=self.batcher.depth(), prefix_hit=hit)
            rec.record("admit", slot=slot.index, prompt_len=r.x.prompt_len, chunked=slot.prefilling,
                       prefix_hit=hit, queue_depth=self.batcher.depth())
            if slot.prefilling:
                continue  # chunked: the first token comes when the prompt is in
            t0 = time.perf_counter()
            try:
                out, hidden_row = self.engine.insert(slot)
            except Exception as e:  # device failure path
                self.engine.abort_slot(slot.index)
                pool.retire(slot.index)
                self._fail(r.future, e)
                continue
            if self.obs.enabled:
                t1 = time.perf_counter()
                self._h_prefill.observe(t1 - t0)
                self.obs.tracer.add_span("prefill_exec", t0, t1, cat="exec", slot=slot.index,
                                         prompt_len=r.x.prompt_len)
            self._emit_first(slot, out, hidden_row)
        chunk_slot = self.engine.prefilling_slot() if self.engine.prefill_chunk else None
        if chunk_slot is not None:
            before = chunk_slot.prefill_pos
            t0 = time.perf_counter()
            try:
                res = self.engine.advance_prefill(chunk_slot)
            except Exception as e:  # device failure path
                self.engine.abort_slot(chunk_slot.index)
                self._fail(pool.retire(chunk_slot.index).future, e)
            else:
                if self.obs.enabled:
                    t1 = time.perf_counter()
                    self._h_chunk.observe(t1 - t0)
                    # offset / wrote / cached show per-chunk progress: a warm
                    # prefix's first span starts at offset == cached > 0
                    cached = (self.engine.pager.prefix_hit(chunk_slot.index)
                              if self.engine.paged and self.engine.prefix_cache else 0)
                    self.obs.tracer.add_span(
                        "prefill_chunk", t0, t1, cat="exec", slot=chunk_slot.index, offset=before,
                        wrote=chunk_slot.prefill_pos - before, prompt_len=chunk_slot.request.prompt_len,
                        cached=cached)
                if res is not None:
                    self._emit_first(chunk_slot, *res)
        active = pool.decoding_indices()
        spec_ran = False
        if active and self.engine.speculative:
            try:
                spec_ran = self._spec_tick(active)
            except Exception as e:  # device failure path
                for i in pool.active_indices():
                    self.engine.abort_slot(i)
                    self._fail(pool.retire(i).future, e)
                spec_ran = True  # the slots failed; no plain decode this tick
        if active and not spec_ran:
            t0 = time.perf_counter()
            try:
                next_tok, hidden = self.engine.decode_step()
            except Exception as e:  # device failure path
                for i in pool.active_indices():
                    self.engine.abort_slot(i)
                    self._fail(pool.retire(i).future, e)
            else:
                if self.obs.enabled:
                    t1 = time.perf_counter()
                    self._h_decode.observe(t1 - t0)
                    self.obs.tracer.add_span("decode_step", t0, t1, cat="exec", lanes=len(active))
                # occupancy counts the lanes that decoded this step
                # (retirement happens after), matching the probe's row feed
                pool.observe_step()
                self._feed_probe(slot_probe_rows(hidden, active))
                for i in active:
                    s = pool[i]
                    tr = _trace_of(s.future)
                    if tr is not None:
                        tr.tick()
                    if s.emit(self._pick_token(s, next_tok[i])):
                        self._finish(pool.retire(i))
        if active or self._pending or reqs:
            rec.record("tick", decoded=len(active), free=pool.free_slots(), pending=len(self._pending),
                       queue_depth=self.batcher.depth())
        self.heartbeat.beat(HEARTBEAT_LM)
        if shutting_down and not pool.active() and not self._pending:
            return None
        return len(self._pending) + len(pool.active())

    def outstanding(self) -> int:
        """Requests queued, deferred or holding a slot — the load signal the
        fabric router reads at dispatch time."""
        return self.batcher.depth() + len(self._pending) + len(self.engine.pool.active())

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

    def warmup(self, prompt_lens=None) -> "LMService":
        """Run every prompt bucket, the pool decode step and the probe window
        once (this builds the CUDA kernels), so no request pays a first call
        (``prompt_lens``: the exact lengths a recurrent arch prefills at; see
        ``ContinuousLMEngine.warmup``)."""
        self.engine.warmup(prompt_lens=prompt_lens)
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
        spec = self.spec_stats.metrics() if self.engine.speculative else None
        return collect_metrics(own, self.engine.pool, paged, spec, self.stats, self.heartbeat, self.probe, self.obs,
                               registry=self.obs.registry)
