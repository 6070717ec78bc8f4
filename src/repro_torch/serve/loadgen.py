"""Load generation + policy comparison for the serving paths (port of the
embedding and LM parts of ``repro/serve/loadgen.py``).

Deterministic synthetic traffic (seeded inputs, seeded exponential
inter-arrivals — numpy, so the port and the reference see the same rows)
driven through two serving policies:

  * ``naive``       — one engine call per request, no coalescing;
  * ``microbatch``  — requests submitted to the ``EmbeddingService`` and
    coalesced by the admission policy into bucketed batches.

Both report per-request p50/p99 latency and sustained throughput.

The LM path runs a deterministic mixed-length workload (``LMLoadConfig``)
through whole-request greedy generation and the continuous-batching
service, dense and paged (with chunked prefill), and holds their tokens
against each other; ``compare_speculative`` holds speculative decoding
against plain paged decoding, and ``compare_prefix_sharing`` the prefix
radix cache against unshared paging on a shared-prefix fan-out workload
(``SharedPrefixLoadConfig``).  The fabric helpers (``FabricLoadConfig``,
``make_lm_fabric``, ``run_fabric``, ``compare_fabric``, ``tp_oracle_err``)
drive ``serve.fabric``: replica scaling, failover on a fake clock and the
tp forward against the unmeshed engine.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike
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
    obs=None,
) -> Dict[str, Dict[str, float]]:
    """Run naive then micro-batched on fresh engines.  ``engine_fn() ->
    ServeEngine``; ``probe_fn() -> DecorrProbe`` (optional; the
    micro-batched run feeds it every dispatched batch); ``obs`` the
    micro-batched service's ``repro_torch.obs.Obs`` bundle."""
    naive = run_naive(engine_fn(), load)
    probe = probe_fn() if probe_fn is not None else None
    service = EmbeddingService(engine_fn(), policy=policy, probe=probe, obs=obs).start()
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


# ---------------------------------------------------------------------------
# LM path: whole-request generate vs continuous batching
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LMLoadConfig:
    """Mixed-length LM workload: request i draws its prompt length and token
    budget round-robin from the ladders below (deterministic given seed;
    the same numpy stream as the reference's)."""

    n_requests: int = 24
    prompt_lens: Tuple[int, ...] = (4, 8, 14, 24)
    new_tokens: Tuple[int, ...] = (4, 12, 20)
    seed: int = 0

    def request_stream(self, vocab_size: int) -> List[Tuple[np.ndarray, int]]:
        """Deterministic ``(tokens, max_new)`` request list."""
        rng = np.random.default_rng(self.seed)
        out = []
        for i in range(self.n_requests):
            s = self.prompt_lens[i % len(self.prompt_lens)]
            m = self.new_tokens[(i // len(self.prompt_lens)) % len(self.new_tokens)]
            out.append((rng.integers(0, vocab_size, size=s).astype(np.int32), int(m)))
        return out

    @property
    def max_request_len(self) -> int:
        """Worst-case rows one request needs (prompt + new tokens)."""
        return max(self.prompt_lens) + max(self.new_tokens)


def _lm_summary(latencies_s: List[float], tokens: int, wall_s: float) -> Dict[str, float]:
    out = _summary(latencies_s, wall_s)
    out["tokens"] = float(tokens)
    out["tok_per_s"] = tokens / max(wall_s, 1e-9)
    return out


def run_whole_request(engine, params, load: LMLoadConfig, max_len: int) -> Tuple[Dict[str, float], List[np.ndarray]]:
    """Each request runs greedy generation to completion at batch 1 before
    the next starts; ``max_len`` is pinned for every request (the cache
    extent the continuous engine uses).  One untimed pass warms up first."""
    device = params["embed"].device
    stream = load.request_stream(engine.cfg.vocab_size)

    def one(tokens: np.ndarray, max_new: int) -> torch.Tensor:
        out = engine.generate(params, torch.as_tensor(tokens[None], device=device), max_new, max_len=max_len)
        _sync(out)
        return out

    for tokens, max_new in stream:
        one(tokens, max_new)
    lat, outs, n_tok = [], [], 0
    t_run = time.perf_counter()
    for tokens, max_new in stream:
        t0 = time.perf_counter()
        out = one(tokens, max_new)
        lat.append(time.perf_counter() - t0)
        outs.append(out[0].cpu().numpy())
        n_tok += int(out.shape[1])
    return _lm_summary(lat, n_tok, time.perf_counter() - t_run), outs


def run_continuous(service, load: LMLoadConfig, timeout_s: float = 600.0):
    """The workload through the continuous-batching service: all requests
    submitted up front (closed-loop burst), drained by synchronous
    decode-step ticks.  Returns (summary with TTFT percentiles, per-request
    outputs)."""
    stream = load.request_stream(service.engine.cfg.vocab_size)
    service.warmup()
    futures = []
    t_run = time.perf_counter()
    for tokens, max_new in stream:
        futures.append(service.submit(tokens, max_new, block=True, timeout=timeout_s))
    service.drain()
    outs = [f.result(timeout=timeout_s) for f in futures]
    wall = time.perf_counter() - t_run
    summary = _lm_summary([f.latency_s for f in futures], sum(len(o) for o in outs), wall)
    ttfts = [f.ttft_s for f in futures]
    summary["ttft_p50_ms"] = float(np.percentile(ttfts, 50) * 1e3)
    summary["ttft_p99_ms"] = float(np.percentile(ttfts, 99) * 1e3)
    return summary, outs


def compare_lm_policies(
    arch_cfg,
    params,
    load: LMLoadConfig,
    *,
    n_slots: int = 8,
    max_len: Optional[int] = None,
    probe_fn=None,
    record_probe_rows: bool = False,
    engine_kw: Optional[Dict] = None,
    device: DeviceLike = None,
    obs=None,
) -> Dict[str, Dict[str, float]]:
    """Whole-request generate vs continuous batching on one mixed-length
    workload; both must emit IDENTICAL token streams per request (greedy
    decoding is deterministic, and slot interleaving must not change any
    request's result).  ``engine_kw`` forwards engine options
    (``paged=True``, ``page_size``, ...); both engines run on ``device``
    (``cuda`` unless ``"cpu"`` is passed), where ``params`` must lie."""
    from repro_torch.serve.engine import ContinuousLMEngine, LMServeEngine
    from repro_torch.serve.service import LMService

    max_len = int(max_len or max(load.max_request_len + 8, 32))
    engine = ContinuousLMEngine(
        arch_cfg, params, n_slots=n_slots, max_len=max_len,
        max_prompt_len=max(load.prompt_lens), device=device, **(engine_kw or {}),
    )
    # the paged engine rounds max_len up to a page multiple; the oracle
    # decodes at the SAME cache extent
    max_len = engine.pool.max_len
    whole, whole_outs = run_whole_request(LMServeEngine(arch_cfg, device), params, load, max_len)
    probe = probe_fn() if probe_fn is not None else None
    service = LMService(engine, probe=probe, record_probe_rows=record_probe_rows, obs=obs)
    cont, cont_outs = run_continuous(service, load)
    mismatches = sum(1 for a, b in zip(whole_outs, cont_outs) if not np.array_equal(a, b))
    out = {
        "whole_request": whole,
        "continuous": cont,
        "service_metrics": service.metrics(),
        "gate": {
            "continuous_beats_whole_request": cont["tok_per_s"] >= whole["tok_per_s"],
            "speedup": cont["tok_per_s"] / max(whole["tok_per_s"], 1e-9),
            "token_mismatches": float(mismatches),
        },
    }
    if record_probe_rows:
        err = lm_probe_oracle_err(service)
        if err is not None:
            out["gate"]["probe_oracle_rel_err"] = err
    return out


def compare_paged_dense(
    arch_cfg,
    params,
    load: LMLoadConfig,
    *,
    n_slots: int = 8,
    max_len: Optional[int] = None,
    page_size: int = 16,
    prefill_chunk: Optional[int] = None,
    device: DeviceLike = None,
) -> Dict[str, Dict[str, float]]:
    """Dense vs paged continuous batching on one workload, on ``device``
    (``cuda`` unless ``"cpu"`` is passed): identical greedy tokens per
    request, tok/s for both, and the paged pool's PEAK allocated cache bytes
    against the dense pool's permanent ``n_slots * max_len`` rows.  With
    ``prefill_chunk`` a third, chunked paged run reports its own token
    mismatches against the dense run (chunking changes the prefill's
    product shapes, so it is argmax-stable rather than bitwise: reported,
    the hard gate rides the unchunked run)."""
    from repro_torch.serve.engine import ContinuousLMEngine
    from repro_torch.serve.paging import dense_cache_bytes
    from repro_torch.serve.service import LMService

    max_len = int(max_len or max(load.max_request_len + 8, 32))
    max_len = -(-max_len // page_size) * page_size  # identical shapes both ways

    def run(**engine_kw):
        engine = ContinuousLMEngine(
            arch_cfg, params, n_slots=n_slots, max_len=max_len,
            max_prompt_len=max(load.prompt_lens), device=device, **engine_kw,
        )
        service = LMService(engine)
        summary, outs = run_continuous(service, load)
        return summary, outs, service

    dense, dense_outs, _ = run()
    paged, paged_outs, paged_svc = run(paged=True, page_size=page_size)
    mismatches = sum(1 for a, b in zip(dense_outs, paged_outs) if not np.array_equal(a, b))
    dense_bytes = dense_cache_bytes(arch_cfg, n_slots, max_len)
    peak_bytes = paged_svc.engine.pager.peak_cache_bytes()
    out = {
        "dense": dict(dense, cache_bytes=float(dense_bytes)),
        "paged": dict(paged, **paged_svc.engine.pager.metrics()),
        "gate": {
            "token_mismatches": float(mismatches),
            "paged_peak_lt_dense": bool(peak_bytes < dense_bytes),
            "peak_cache_bytes_ratio": peak_bytes / max(dense_bytes, 1),
            "tok_per_s_ratio": paged["tok_per_s"] / max(dense["tok_per_s"], 1e-9),
        },
    }
    if prefill_chunk:
        chunked, chunked_outs, chunked_svc = run(paged=True, page_size=page_size, prefill_chunk=prefill_chunk)
        out["paged_chunked"] = dict(
            chunked,
            token_mismatches=float(sum(1 for a, b in zip(dense_outs, chunked_outs) if not np.array_equal(a, b))),
            ttft_p50_ms=chunked_svc.metrics()["ttft_p50_ms"],
        )
    return out


def compare_speculative(
    arch_cfg,
    params,
    load: LMLoadConfig,
    *,
    n_slots: int = 8,
    max_len: Optional[int] = None,
    page_size: int = 16,
    draft_k: int = 4,
    spec_ngram_max: int = 3,
    spec_ngram_min: int = 1,
    device: DeviceLike = None,
) -> Dict[str, Dict[str, float]]:
    """Plain paged vs self-drafting speculative decoding on one workload, on
    ``device``.  Both runs use the same paged engine; the speculative run
    adds the n-gram drafter and the lane-batched verify.  Greedy
    verification means tokens must be IDENTICAL per request (the hard gate
    on the CPU); the speed story is tokens per step — ``accepted_tokens``
    (mean tokens per verify step) above 1, and tok/s against the plain
    run.  Interleaved best-of-3 passes: wall clock is noisy at this scale."""
    from repro_torch.serve.engine import ContinuousLMEngine
    from repro_torch.serve.service import LMService

    max_len = int(max_len or max(load.max_request_len + 8, 32))
    max_len = -(-max_len // page_size) * page_size  # identical shapes both ways

    def build(**engine_kw):
        engine = ContinuousLMEngine(
            arch_cfg, params, n_slots=n_slots, max_len=max_len, max_prompt_len=max(load.prompt_lens),
            paged=True, page_size=page_size, device=device, **engine_kw,
        )
        return LMService(engine)

    plain_svc = build()
    spec_svc = build(speculative=True, draft_k=draft_k, spec_ngram_max=spec_ngram_max,
                     spec_ngram_min=spec_ngram_min)
    plain = spec = plain_outs = spec_outs = None
    for _ in range(3):
        p, p_outs = run_continuous(plain_svc, load)
        if plain is None or p["tok_per_s"] > plain["tok_per_s"]:
            plain, plain_outs = p, p_outs
        q, q_outs = run_continuous(spec_svc, load)
        if spec is None or q["tok_per_s"] > spec["tok_per_s"]:
            spec, spec_outs = q, q_outs
    mismatches = sum(1 for a, b in zip(plain_outs, spec_outs) if not np.array_equal(a, b))
    sm = spec_svc.spec_stats
    return {
        "plain": plain,
        "speculative": dict(spec, **sm.metrics()),
        "gate": {
            "token_mismatches": float(mismatches),
            "spec_beats_plain": bool(spec["tok_per_s"] >= plain["tok_per_s"]),
            "tok_per_s_ratio": spec["tok_per_s"] / max(plain["tok_per_s"], 1e-9),
            "accepted_tokens_per_step": sm.accepted_per_step(),
            # per slot-lane: > 1 means a slot on a verify tick emitted more
            # than the single token plain decode would have
            "tokens_per_lane": sm.tokens_emitted / max(sm.slot_lanes, 1),
            "draft_hit_rate": sm.hit_rate(),
            "acceptance_rate": sm.acceptance_rate(),
        },
    }


@dataclasses.dataclass(frozen=True)
class SharedPrefixLoadConfig:
    """Shared-prefix LM workload (the RAG / few-shot / system-prompt shape):
    ``n_prefixes`` distinct long prefixes, each fanned out to ``fan_out``
    requests appending a short unique tail.  Two phases: one COLD request
    per prefix first (its retirement donates the prefix pages to the radix
    cache when sharing is on), then the WARM fan-out whose TTFT the
    comparison reads.  The same numpy stream as the reference's.

    The defaults stress sharing: decode long enough that slots overlap in
    both runs, and a prefix long enough that the pages saved by sharing
    outweigh what the cache retains.  prefix_len=92 with page 16 / chunk 8
    also takes copy-on-write: a cold tail can extend the donated pages past
    the common prefix, so a warm hit lands mid-page (88 rows) and copies the
    boundary page."""

    n_prefixes: int = 2
    fan_out: int = 7
    prefix_len: int = 92
    tail_lens: Tuple[int, ...] = (3, 5, 9)
    new_tokens: Tuple[int, ...] = (32, 48)
    seed: int = 0

    def request_stream(self, vocab_size: int) -> Tuple[List[Tuple[np.ndarray, int]], List[Tuple[np.ndarray, int]]]:
        """Deterministic (cold, warm) request lists of ``(tokens, max_new)``."""
        rng = np.random.default_rng(self.seed)
        cold, warm = [], []
        for p in range(self.n_prefixes):
            prefix = rng.integers(0, vocab_size, size=self.prefix_len).astype(np.int32)
            for f in range(self.fan_out):
                i = p * self.fan_out + f
                t = int(self.tail_lens[i % len(self.tail_lens)])
                m = int(self.new_tokens[i % len(self.new_tokens)])
                tail = rng.integers(0, vocab_size, size=t).astype(np.int32)
                (cold if f == 0 else warm).append((np.concatenate([prefix, tail]), m))
        return cold, warm

    @property
    def prompt_lens(self) -> Tuple[int, ...]:
        """Distinct total prompt lengths in the two-phase stream."""
        return tuple(sorted({self.prefix_len + t for t in self.tail_lens}))

    @property
    def max_request_len(self) -> int:
        """Worst-case rows one request needs (prefix + tail + new tokens)."""
        return self.prefix_len + max(self.tail_lens) + max(self.new_tokens)


def run_prefix_workload(service, load: SharedPrefixLoadConfig, timeout_s: float = 600.0):
    """Cold phase, drained (so retiring prompts can donate pages to the
    radix cache), then the warm fan-out as a closed-loop burst.  Returns
    ``(summary, outs)`` with ``outs`` cold first, then warm; the summary's
    ``warm_ttft_*`` percentiles cover the warm phase only — the latency the
    prefix cache is meant to cut — and ``cold_ttft_*`` the cold phase."""
    cold, warm = load.request_stream(service.engine.cfg.vocab_size)
    service.warmup()
    t_run = time.perf_counter()
    cold_futs = [service.submit(t, m, block=True, timeout=timeout_s) for t, m in cold]
    service.drain()
    warm_futs = [service.submit(t, m, block=True, timeout=timeout_s) for t, m in warm]
    service.drain()
    futs = cold_futs + warm_futs
    outs = [f.result(timeout=timeout_s) for f in futs]
    wall = time.perf_counter() - t_run
    summary = _lm_summary([f.latency_s for f in futs], sum(len(o) for o in outs), wall)
    for phase, group in (("cold", cold_futs), ("warm", warm_futs)):
        ttfts = [f.ttft_s for f in group]
        if ttfts:
            summary[f"{phase}_ttft_p50_ms"] = float(np.percentile(ttfts, 50) * 1e3)
            summary[f"{phase}_ttft_p99_ms"] = float(np.percentile(ttfts, 99) * 1e3)
    return summary, outs


def compare_prefix_sharing(
    arch_cfg,
    params,
    load: SharedPrefixLoadConfig,
    *,
    n_slots: int = 8,
    max_len: Optional[int] = None,
    page_size: int = 16,
    prefill_chunk: int = 8,
    total_pages: Optional[int] = None,
    probe_fn=None,
    record_probe_rows: bool = False,
    device: DeviceLike = None,
) -> Dict[str, Dict[str, float]]:
    """Prefix sharing ON vs OFF over the same paged chunk-all engine on the
    same two-phase workload, on ``device``.  The OFF run uses
    ``chunk_all=True`` too, so both runs execute the same chunk and decode
    steps on the same values — greedy tokens must be IDENTICAL per request
    (the hard gate, on either route).  The speed story: warm-phase TTFT and
    the pool's peak allocated pages both below the unshared run's."""
    from repro_torch.serve.engine import ContinuousLMEngine
    from repro_torch.serve.service import LMService

    max_len = int(max_len or max(load.max_request_len + 8, 32))
    max_len = -(-max_len // page_size) * page_size  # identical shapes both ways

    def run(prefix_cache: bool):
        engine = ContinuousLMEngine(
            arch_cfg, params, n_slots=n_slots, max_len=max_len, max_prompt_len=max(load.prompt_lens),
            paged=True, page_size=page_size, prefill_chunk=prefill_chunk, chunk_all=True,
            prefix_cache=prefix_cache, total_pages=total_pages, device=device,
        )
        probe = probe_fn() if (probe_fn is not None and prefix_cache) else None
        service = LMService(engine, probe=probe, record_probe_rows=record_probe_rows and prefix_cache)
        summary, outs = run_prefix_workload(service, load)
        return summary, outs, service

    base, base_outs, base_svc = run(prefix_cache=False)
    shared, shared_outs, shared_svc = run(prefix_cache=True)
    mismatches = sum(1 for a, b in zip(base_outs, shared_outs) if not np.array_equal(a, b))
    base_peak = base_svc.engine.pager.alloc.peak_pages
    shared_peak = shared_svc.engine.pager.alloc.peak_pages
    pm = shared_svc.engine.pager.metrics()
    out = {
        "unshared": dict(base, peak_pages=float(base_peak)),
        "shared": dict(shared, peak_pages=float(shared_peak), **pm),
        "gate": {
            "token_mismatches": float(mismatches),
            "warm_ttft_lt_unshared": bool(shared["warm_ttft_p50_ms"] < base["warm_ttft_p50_ms"]),
            "warm_ttft_ratio": shared["warm_ttft_p50_ms"] / max(base["warm_ttft_p50_ms"], 1e-9),
            "peak_pages_lt_unshared": bool(shared_peak < base_peak),
            "peak_pages_ratio": shared_peak / max(base_peak, 1),
            "prefix_hit_rate": pm["paged_prefix_hit_rate"],
            "prefix_cow_total": pm["paged_prefix_cow_total"],
        },
    }
    if record_probe_rows:
        err = lm_probe_oracle_err(shared_svc)
        if err is not None:
            out["gate"]["probe_oracle_rel_err"] = err
    return out


def lm_probe_oracle_err(service) -> Optional[float]:
    """Replay the last full probe window against the probe's offline oracle:
    ``probe_metrics`` on the plain route (``impl="plain"``) with the same
    step's permutation.  Needs ``record_probe_rows=True`` and a fired probe;
    returns the max relative error across the exported metrics, or None."""
    from repro_torch.decorr.probe import probe_metrics

    probe = service.probe
    if probe is None or probe.steps == 0 or not service.probe_rows:
        return None
    w = probe.sample_rows
    flat = np.concatenate(service.probe_rows, axis=0)
    step = probe.steps - 1
    window = torch.as_tensor(flat[step * w : (step + 1) * w], device=probe.device)
    perm = probe.permutation(step, window.shape[1])
    oracle = probe_metrics(window, None, probe.cfg, perm, include_off=probe._include_off, impl="plain")
    got = probe.metrics()
    return max(
        abs(got[f"decorr_{k}"] - float(v)) / max(abs(float(v)), 1e-6) for k, v in oracle.items()
    )


# ---------------------------------------------------------------------------
# Fabric: replica scaling, deterministic failover, tp-forward oracle
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FabricLoadConfig:
    """Mixed fabric workload: the LM request ladder routed across replicas
    plus an embedding side-channel (both numpy-seeded, so the streams equal
    the reference's).  The LM stream is what the scaling and failover checks
    measure; the embedding stream rides along to exercise per-kind routing."""

    lm: LMLoadConfig = LMLoadConfig(n_requests=16, prompt_lens=(4, 8, 14), new_tokens=(8, 16))
    n_embed: int = 0
    embed_rows: int = 4
    input_dim: int = 24
    seed: int = 0

    def embed_stream(self) -> List[np.ndarray]:
        """Deterministic embedding request list (empty when n_embed=0)."""
        rng = np.random.default_rng(self.seed + 1)
        return [rng.standard_normal((self.embed_rows, self.input_dim)).astype(np.float32) for _ in range(self.n_embed)]


def make_lm_fabric(
    arch_cfg,
    params,
    fabric_cfg,
    load: FabricLoadConfig,
    *,
    n_slots: int = 4,
    max_len: Optional[int] = None,
    page_size: int = 16,
    embed_cfg=None,
    embed_model=None,
    obs=None,
    clock=None,
    engine_kw: Optional[Dict] = None,
    device: DeviceLike = None,
):
    """Stand up a ``ServeFabric`` whose every replica runs a FRESH paged
    continuous engine (and, when ``embed_cfg`` is given, a fresh embedding
    service over ``embed_model``) on ``device`` (``cuda`` unless ``"cpu"``
    is passed), all sharing the read-only ``params``.  Returns ``(fabric,
    max_len)`` — the pinned cache extent a bit-identity oracle must decode at."""
    from repro_torch.obs import Obs
    from repro_torch.serve.engine import ContinuousLMEngine
    from repro_torch.serve.fabric import ServeFabric
    from repro_torch.serve.service import LMService

    lm_load = load.lm
    max_len = int(max_len or max(lm_load.max_request_len + 8, 32))
    max_len = -(-max_len // page_size) * page_size

    def lm_factory(name):
        engine = ContinuousLMEngine(
            arch_cfg, params, n_slots=n_slots, max_len=max_len, max_prompt_len=max(lm_load.prompt_lens),
            paged=True, page_size=page_size, device=device, **(engine_kw or {}),
        )
        return LMService(engine, obs=Obs())

    embed_factory = None
    if embed_cfg is not None:
        def embed_factory(name):
            return EmbeddingService(ServeEngine(embed_cfg, embed_model, device=device), obs=Obs())

    fabric = ServeFabric(fabric_cfg, lm_factory=lm_factory, embed_factory=embed_factory, obs=obs,
                         clock=clock or time.monotonic)
    return fabric, max_len


def run_fabric(fabric, load: FabricLoadConfig, *, timeout_s: float = 300.0):
    """Drive one closed-loop burst through the fabric (threaded when
    ``fabric.start()`` was called, synchronous ticking otherwise).  Returns
    ``(summary, lm_outs, embed_outs)`` — outputs in submit order, so two runs
    over the same load compare stream for stream."""
    lm_svc = next(r.lm for r in fabric.replicas if r.lm is not None)
    stream = load.lm.request_stream(lm_svc.engine.cfg.vocab_size)
    lm_futs, em_futs = [], []
    t_run = time.perf_counter()
    for tokens, max_new in stream:
        lm_futs.append(fabric.submit_lm(tokens, max_new))
    for x in load.embed_stream():
        em_futs.append(fabric.submit_embed(x))
    fabric.drain(timeout_s=timeout_s)
    lm_outs = [f.result(timeout=timeout_s) for f in lm_futs]
    em_outs = [_host(f.result(timeout=timeout_s)) for f in em_futs]
    wall = time.perf_counter() - t_run
    n_tok = sum(len(o) for o in lm_outs)
    summary = _lm_summary([f.latency_s for f in lm_futs], n_tok, wall)
    return summary, lm_outs, em_outs


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def compare_fabric(
    arch_cfg,
    params,
    load: FabricLoadConfig,
    *,
    replicas: int = 2,
    n_slots: int = 4,
    page_size: int = 16,
    embed_cfg=None,
    embed_model=None,
    heartbeat_timeout_s: float = 5.0,
    repeats: int = 3,
    obs=None,
    device: DeviceLike = None,
) -> Dict[str, Dict[str, float]]:
    """Three-leg fabric comparison on one deterministic workload:

      * ``single`` / ``multi`` — threaded 1-replica vs N-replica fabrics,
        interleaved best-of-``repeats``; route-independent token identity
        (``token_mismatches``) and the tok/s ratio ``scaling_x``;
      * ``failover`` — a synchronous 2-replica fabric on a FAKE clock: one
        replica is killed mid-decode, the clock jumps past the heartbeat
        timeout, and every requeued request must still emit the exact
        single-replica token stream (``requeue_token_mismatches == 0``).
    """
    from repro_torch.serve.fabric import FabricConfig

    def build(n, clock=None, fab_obs=None):
        return make_lm_fabric(
            arch_cfg, params, FabricConfig(replicas=n, heartbeat_timeout_s=heartbeat_timeout_s), load,
            n_slots=n_slots, page_size=page_size, embed_cfg=embed_cfg, embed_model=embed_model,
            obs=fab_obs, clock=clock, device=device,
        )

    prompt_lens = [int(t.shape[0]) for t, _ in load.lm.request_stream(arch_cfg.vocab_size)]
    single_fab, _ = build(1)
    multi_fab, _ = build(replicas, fab_obs=obs)
    for fab in (single_fab, multi_fab):
        fab.warmup(prompt_lens=prompt_lens).start()
    # interleaved best-of-N: wall clock is noisy and drifts over a run —
    # alternating passes samples both fabrics under like conditions, and the
    # token streams are deterministic on every pass
    single = multi = single_outs = multi_outs = single_em = multi_em = None
    try:
        for _ in range(max(1, repeats)):
            s, s_outs, s_em = run_fabric(single_fab, load)
            if single is None or s["tok_per_s"] > single["tok_per_s"]:
                single, single_outs, single_em = s, s_outs, s_em
            m, m_outs, m_em = run_fabric(multi_fab, load)
            if multi is None or m["tok_per_s"] > multi["tok_per_s"]:
                multi, multi_outs, multi_em = m, m_outs, m_em
    finally:
        single_fab.stop()
        multi_fab.stop()
    route_mismatches = sum(1 for a, b in zip(single_outs, multi_outs) if not np.array_equal(a, b))
    embed_err = 0.0
    for a, b in zip(single_em, multi_em):
        embed_err = max(embed_err, float(np.max(np.abs(a - b))))

    # failover leg: synchronous ticking on a fake clock so the kill is
    # mid-decode by construction and detection never sleeps
    t = {"now": 0.0}
    fail_fab, _ = build(2, clock=lambda: t["now"])
    fail_fab.warmup(prompt_lens=prompt_lens)
    stream = load.lm.request_stream(arch_cfg.vocab_size)
    futs = [fail_fab.submit_lm(tok, mn) for tok, mn in stream]
    for _ in range(3):  # let both replicas admit + decode a few ticks
        fail_fab.step()
    fail_fab.kill("r0")
    t["now"] += heartbeat_timeout_s * 2
    fail_fab.drain()
    fail_outs = [f.result(timeout=0) for f in futs]
    requeue_mismatches = sum(1 for a, b in zip(single_outs, fail_outs) if not np.array_equal(a, b))
    degraded = _lm_summary([f.latency_s for f in futs], sum(len(o) for o in fail_outs), 1.0)

    return {
        "single": single,
        "multi": multi,
        "failover": {
            "requeued": float(fail_fab.requeued_total),
            "replicas_dead": float(fail_fab.dead_total),
            "degraded_p99_ms": degraded["p99_ms"],
        },
        "fabric_metrics": multi_fab.metrics(),
        "gate": {
            "replicas": float(replicas),
            "scaling_x": multi["tok_per_s"] / max(single["tok_per_s"], 1e-9),
            "token_mismatches": float(route_mismatches),
            "embed_max_abs_err": embed_err,
            "requeue_token_mismatches": float(requeue_mismatches),
            "requeued": float(fail_fab.requeued_total),
        },
    }


def tp_oracle_err(model_cfg, model, *, tp: int = 2, n: int = 24, seed: int = 0, offset: int = 0,
                  device: DeviceLike = None) -> Optional[float]:
    """Max relative error between the feature-sharded tp forward
    (``ServeEngine(mesh=, model_axis="model")`` over the ``(1, tp)`` replica
    mesh of ranks ``[offset, offset + tp)``, ``make_replica_mesh``) and the
    unmeshed engine on one deterministic batch.  Every rank of the process
    group must call it (building the mesh is collective); a rank outside
    the mesh returns None."""
    from repro_torch.serve.fabric import make_replica_mesh

    mesh = make_replica_mesh(tp=tp, offset=offset)
    if mesh is None or mesh.get_coordinate() is None:
        return None
    x = np.random.default_rng(seed).standard_normal((n, model_cfg.input_dim)).astype(np.float32)
    ref = _host(ServeEngine(model_cfg, model, device=device).encode(x))
    got = _host(ServeEngine(model_cfg, model, mesh=mesh, model_axis="model", device=device).encode(x))
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-12))
