"""Serve CLI: load-generate against the embedding or LM service and print
the scrape metrics (port of ``repro/serve/cli.py``).

    # reduced end-to-end smoke: naive vs micro-batched + probes, on the CPU
    PYTHONPATH=src python -m repro_torch.serve.cli --smoke --device cpu

    # the ssl-paper width on the GPU, grouped probe at the paper's b = 128
    PYTHONPATH=src python -m repro_torch.serve.cli --d 2048 --max-batch 256 \
        --probe-block 128

    # whole-request greedy generate of any of the ten LM archs (reduced;
    # musicgen-large generates (batch, tokens, 4) codes)
    PYTHONPATH=src python -m repro_torch.serve.cli --lm-arch rwkv6-3b --device cpu

    # LM serving (reduced gemma2-2b): continuous batching vs whole-request
    # greedy, paged KV cache vs dense, the in-flight probe vs its oracle
    PYTHONPATH=src python -m repro_torch.serve.cli --smoke --lm-arch gemma2-2b \
        --continuous --paged --block-size 16 --device cpu

    # + chunked prefill (a third, chunked paged run) and a sampled batch
    PYTHONPATH=src python -m repro_torch.serve.cli --smoke --lm-arch gemma2-2b \
        --continuous --paged --block-size 16 --prefill-chunk 16 \
        --temperature 0.8 --top-k 8 --device cpu

    # + the prefix radix cache (identical tokens, fewer peak pages, hits)
    PYTHONPATH=src python -m repro_torch.serve.cli --smoke --lm-arch gemma2-2b \
        --continuous --paged --block-size 16 --prefix-cache --device cpu

    # + speculative decoding (identical tokens, > 1 token per verify lane)
    PYTHONPATH=src python -m repro_torch.serve.cli --smoke --lm-arch gemma2-2b \
        --continuous --paged --block-size 16 --speculative --draft-k 4 --device cpu

    # + the fabric failover gate: a 2-replica fabric on a fake clock, r0
    # killed after 3 ticks; requeued requests == a 1-replica run, bit for bit
    PYTHONPATH=src python -m repro_torch.serve.cli --smoke --lm-arch gemma2-2b \
        --continuous --paged --fabric --replicas 2 --device cpu

    # warm the repro_torch.tune choices of the serve buckets' probe shapes
    # first (forward only: the job list python -m repro_torch.tune.cli --serve
    # persists offline)
    PYTHONPATH=src python -m repro_torch.serve.cli --smoke --pretune analytic --device cpu

    # serve what a training run saved (here the training CLI's --tiny model)
    PYTHONPATH=src python -m repro_torch.train.cli --tiny --steps 6 --ckpt-dir /tmp/ssl_ckpt --device cpu
    PYTHONPATH=src python -m repro_torch.serve.cli --ckpt-dir /tmp/ssl_ckpt \
        --input-dim 256 --backbone 128 --d 256 --requests 64 --device cpu

    # telemetry: self-scrape /metrics on an ephemeral port (every metrics()
    # key must be in the exposition), the Chrome trace, the exposition text,
    # the flight recorder and a torch.profiler trace
    PYTHONPATH=src python -m repro_torch.serve.cli --smoke --device cpu \
        --metrics-port 0 --trace-out /tmp/trace.json --metrics-out /tmp/metrics.txt \
        --flight-out /tmp/flight.json --profile-dir /tmp/prof

Like the reference, the LM paths serve ``cfg.reduced()``; ``chip_smoke.py``
runs the full published width on the card.  Without ``--block-size`` the
continuous engine's page is ``auto_page_size``'s pick for its pool.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _build_obs(args):
    """The CLI's telemetry bundle: default serve alert rules unless
    ``--alerts`` points at a JSON rule list (file path or inline)."""
    from repro_torch.obs import AlertManager, Obs, default_serve_rules

    alerts = AlertManager.from_config(args.alerts) if args.alerts else AlertManager(default_serve_rules())
    return Obs(alerts=alerts)


def _finish_obs(args, obs, report_metrics) -> bool:
    """Post-run telemetry outputs: self-scrape the HTTP endpoint
    (``--metrics-port``; fails unless every ``metrics()`` key survived into
    the exposition), dump the Chrome trace (``--trace-out``), the exposition
    text (``--metrics-out``) and the flight recorder (``--flight-out``)."""
    from repro_torch.obs.registry import sanitize_name

    ok = True
    exposition = None
    if args.metrics_port is not None:
        import urllib.request

        server = obs.start_server(port=args.metrics_port)
        text = urllib.request.urlopen(f"{server.url}/metrics", timeout=10).read().decode()
        exposition = text
        exposed = {line.split("{")[0].split(" ")[0] for line in text.splitlines() if line and not line.startswith("#")}
        missing = []
        for k in report_metrics:
            s = sanitize_name(k)
            if s in exposed:
                continue
            # per-name heartbeat ages live in the labelled family
            # heartbeat_age_s{name=...}; the name-suffixed keys only in metrics()
            if s.startswith("heartbeat_age_s_") and "heartbeat_age_s" in exposed:
                continue
            missing.append(k)
        print(f"[obs] scrape {server.url}/metrics: {len(text.splitlines())} lines, "
              f"{len(exposed)} series, active_alerts={obs.alerts.active()}")
        if missing:
            print(f"[obs] MISSING from exposition: {missing[:8]}")
            ok = False
        server.stop()
    top = obs.perf.snapshot(top_k=3)
    if top:
        slowest = ", ".join(f"{r['executable']} ({r['calls']}x, {r['total_s']:.3f}s)" for r in top)
        print(f"[obs] slowest executables: {slowest}")
    if args.trace_out:
        obs.tracer.write(args.trace_out)
        print(f"[obs] trace: {len(obs.tracer)} events -> {args.trace_out}")
    if args.metrics_out:
        if exposition is None:
            exposition = obs.scrape()
        with open(args.metrics_out, "w") as f:
            f.write(exposition)
        print(f"[obs] exposition -> {args.metrics_out}")
    if args.flight_out:
        obs.recorder.dump_json(args.flight_out)
        print(f"[obs] flight recorder: {len(obs.recorder)} events -> {args.flight_out}")
    return ok


def _build(args):
    from repro_torch import resolve_device
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.serve.buckets import BucketPolicy
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.probes import DecorrProbe
    from repro_torch.train.ssl import SSLModelConfig, init_ssl_model

    device = resolve_device(args.device)
    model_cfg = SSLModelConfig(
        input_dim=args.input_dim,
        backbone_widths=(args.backbone,),
        projector_widths=(args.d, args.d),
    )
    policy = BucketPolicy(
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms, max_queue=args.max_queue
    )

    def engine_fn():
        if args.ckpt_dir:
            return ServeEngine.from_checkpoint(args.ckpt_dir, model_cfg, policy=policy, device=device)
        model = init_ssl_model(model_cfg, seed=args.seed)
        return ServeEngine(model_cfg, model, policy=policy, device=device)

    probe_cfg = DecorrConfig(style=args.probe_style, reg="sum", q=2, block_size=args.probe_block)
    return policy, engine_fn, lambda: DecorrProbe(probe_cfg, device=device)


def _pretune(args, policy) -> None:
    """Warm the tuned choices of every serve bucket's probe shapes (forward
    only: the probes never differentiate)."""
    from repro_torch import tune
    from repro_torch.serve.buckets import bucket_sizes
    from repro_torch.tune.cli import jobs_for

    n_jobs = 0
    for b in bucket_sizes(policy):
        _, jobs = jobs_for(b, args.d, block_size=args.probe_block, forward_only=True, mode=args.pretune,
                           persist=False, device=args.device)
        n_jobs += 1 + len(jobs)
        for kernel, shape in jobs:
            tune.tune(kernel, shape, mode=args.pretune, persist=False, device=args.device)
    print(f"[serve] pre-tuned {n_jobs} forward bucket shapes ({args.pretune})")


def _run_embedding(args) -> int:
    from repro_torch.serve.buckets import bucket_sizes
    from repro_torch.serve.loadgen import LoadConfig, compare_policies

    policy, engine_fn, probe_fn = _build(args)
    if args.pretune != "off":
        _pretune(args, policy)
    load = LoadConfig(
        n_requests=args.requests,
        input_dim=args.input_dim,
        arrival_rps=args.arrival_rps,
        seed=args.seed,
    )
    print(
        f"[serve] device={args.device or 'cuda'} d={args.d} requests={load.n_requests} "
        f"buckets={list(bucket_sizes(policy))} max_wait={policy.max_wait_ms}ms"
    )
    obs = _build_obs(args)
    if args.profile_dir:
        obs.profiler.start(args.profile_dir)
    report = compare_policies(engine_fn, load, policy, probe_fn=probe_fn, obs=obs)
    if args.profile_dir:
        path = obs.profiler.stop()
        if path:
            print(f"[obs] profiler trace -> {path}")
    rows = report["microbatch"].pop("rows")
    for name in ("naive", "microbatch"):
        r = report[name]
        print(
            f"[serve] {name:>10}: p50={r['p50_ms']:.2f}ms p99={r['p99_ms']:.2f}ms "
            f"throughput={r['throughput_rps']:.0f} req/s"
        )
    g = report["gate"]
    print(f"[serve] micro-batching speedup: {g['speedup']:.2f}x "
          f"(beats naive: {g['microbatch_beats_naive']})")
    m = report["service_metrics"]
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True, default=float))
    else:
        probes = {k: round(v, 6) for k, v in m.items() if k.startswith("decorr_")}
        print(f"[serve] probe metrics: {probes}")
        print(f"[serve] heartbeat stale={m['heartbeat_stale']:.0f} "
              f"missed={m['heartbeat_missed_events']:.0f} "
              f"dispatch_errors={m['dispatch_errors']:.0f}")
    obs_ok = _finish_obs(args, obs, m)
    healthy = (
        m["dispatch_errors"] == 0
        and m["decorr_probe_steps"] > 0
        and bool(np.all(np.isfinite(rows)))
        and all(np.isfinite(v) for k, v in m.items() if k.startswith("decorr_"))
        and obs_ok
    )
    print(f"[serve] healthy={healthy} (no dispatch error, probe fired, finite rows and probes"
          + (", every metric scraped" if args.metrics_port is not None else "") + ")")
    if not healthy:
        return 1
    return 0 if g["microbatch_beats_naive"] or not args.gate else 1


def _run_lm(args) -> int:
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve.common import make_prompt, timed_generate
    from repro_torch.serve.engine import LMServeEngine

    device = resolve_device(args.device)
    cfg = get_config(args.lm_arch).reduced()
    params = init_params(cfg, seed=args.seed, device=device)
    if args.continuous:
        return _run_lm_continuous(args, cfg, params, device)
    if args.paged:
        raise SystemExit("--paged serves the continuous-batching pool; add --continuous")
    engine = LMServeEngine(cfg, device)
    prompt = make_prompt(cfg, args.seed + 1, args.max_batch, args.prompt_len, device=device)
    out, stats = timed_generate(params, cfg, prompt, args.new_tokens, steps=engine.steps)
    print(
        f"[serve] lm arch={cfg.name} (reduced): batch={prompt.shape[0]} "
        f"prompt={args.prompt_len} -> {args.new_tokens} tokens in "
        f"{stats['seconds']:.2f}s ({stats['tok_per_s']:.1f} tok/s)"
    )
    print("sample:", out[0].tolist()[:8])
    return 0


def _run_lm_continuous(args, cfg, params, device) -> int:
    """Continuous batching vs whole-request greedy on a mixed-length
    workload (identical tokens required), the in-flight probe replayed
    against its oracle, and with ``--paged`` the paged pool against the
    dense one (identical tokens, peak cache bytes below the dense pool's)."""
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.serve.loadgen import LMLoadConfig, compare_lm_policies, compare_paged_dense
    from repro_torch.serve.probes import DecorrProbe

    engine_kw = dict(paged=True, page_size=args.block_size) if args.paged else {}
    load = LMLoadConfig(n_requests=args.requests, seed=args.seed)
    probe_cfg = DecorrConfig(style=args.probe_style, reg="sum", q=2, block_size=args.probe_block)
    obs = _build_obs(args)
    if args.profile_dir:
        obs.profiler.start(args.profile_dir)
    report = compare_lm_policies(
        cfg, params, load, n_slots=args.slots,
        probe_fn=lambda: DecorrProbe(probe_cfg, device=device),
        record_probe_rows=True, engine_kw=engine_kw, device=device, obs=obs,
    )
    if args.profile_dir:
        path = obs.profiler.stop()
        if path:
            print(f"[obs] profiler trace -> {path}")
    for name in ("whole_request", "continuous"):
        r = report[name]
        print(
            f"[serve] {name:>14}: p50={r['p50_ms']:.2f}ms p99={r['p99_ms']:.2f}ms "
            f"{r['tok_per_s']:.0f} tok/s ({r['requests']:.0f} requests)"
        )
    g = report["gate"]
    m = report["service_metrics"]
    probe_err = g.get("probe_oracle_rel_err")
    print(
        f"[serve] continuous-batching speedup: {g['speedup']:.2f}x "
        f"(beats whole-request: {g['continuous_beats_whole_request']}, "
        f"token mismatches: {g['token_mismatches']:.0f})"
    )
    print(
        f"[serve] occupancy={m['slots_occupancy']:.2f} ttft_p50={m['ttft_p50_ms']:.2f}ms "
        f"probe_steps={m.get('decorr_probe_steps', 0):.0f} "
        f"probe_oracle_rel_err={float('nan') if probe_err is None else probe_err:.2e} "
        f"dispatch_errors={m['dispatch_errors']:.0f}"
    )
    paged_ok = True
    if args.paged:
        rep = compare_paged_dense(
            cfg, params, load, n_slots=args.slots, page_size=args.block_size or 16,
            prefill_chunk=args.prefill_chunk, device=device,
        )
        pg = rep["gate"]
        print(
            f"[serve] paged vs dense: peak_cache_bytes_ratio={pg['peak_cache_bytes_ratio']:.3f} "
            f"(paged<dense: {pg['paged_peak_lt_dense']}, token mismatches: {pg['token_mismatches']:.0f}, "
            f"tok/s ratio {pg['tok_per_s_ratio']:.2f})"
        )
        paged_ok = pg["paged_peak_lt_dense"] and pg["token_mismatches"] == 0
        if "paged_chunked" in rep:
            ch = rep["paged_chunked"]
            print(f"[serve] chunked prefill ({args.prefill_chunk} tokens a tick): "
                  f"token mismatches vs dense: {ch['token_mismatches']:.0f} (argmax-stable, reported) "
                  f"ttft_p50={ch['ttft_p50_ms']:.2f}ms")
        report["paged_vs_dense"] = rep
    prefix_ok, prefix_fast = _gate_prefix(args, cfg, params, device) if args.prefix_cache else (True, True)
    spec_ok = _gate_speculative(args, cfg, params, device) if args.speculative else True
    fabric_ok = _gate_fabric(args, cfg, params, device) if args.fabric else True
    sample_ok = _demo_sampling(args, cfg, params, device) if (args.temperature or args.top_k) else True
    obs_ok = _finish_obs(args, obs, m)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True, default=float))
    # fail-closed: a probe that never fired a full window means the oracle
    # check did not run
    healthy = (
        g["token_mismatches"] == 0
        and probe_err is not None
        and probe_err < 1e-3
        and m["dispatch_errors"] == 0
        and paged_ok
        and prefix_ok
        and spec_ok
        and fabric_ok
        and sample_ok
        and obs_ok
    )
    print(f"[serve] healthy={healthy} (tokens identical, probe vs oracle < 1e-3, no dispatch error"
          + (", paged == dense and below its bytes" if args.paged else "")
          + (", warm prefix == unshared with fewer peak pages and hits" if args.prefix_cache else "")
          + (", speculative == plain with > 1 token a verify lane" if args.speculative else "")
          + (", failover tokens == 1 replica with requeues and one death" if args.fabric else "")
          + (", sampled tokens reproducible" if args.temperature or args.top_k else "") + ")")
    if not healthy:
        return 1
    fast = g["continuous_beats_whole_request"] and prefix_fast
    return 0 if fast or not args.gate else 1


def _gate_prefix(args, cfg, params, device):
    """Prefix sharing on vs off over the same paged chunk-all engine on the
    shared-prefix fan-out workload.  Returns (healthy: identical tokens,
    peak pool pages below the unshared run, a hit rate above 0; fast: warm
    TTFT below the unshared run's, a speed claim gated under ``--gate``).  The
    engine shape is the reference's (4 slots, page 16, chunk 8: the chunk
    halves the page, so copy-on-write happens)."""
    from repro_torch.serve.loadgen import SharedPrefixLoadConfig, compare_prefix_sharing

    rep = compare_prefix_sharing(cfg, params, SharedPrefixLoadConfig(seed=args.seed), n_slots=4,
                                 page_size=16, prefill_chunk=8, device=device)
    g = rep["gate"]
    print(
        f"[serve] prefix cache: hit_rate={g['prefix_hit_rate']:.2f} cow={g['prefix_cow_total']:.0f} "
        f"warm_ttft_ratio={g['warm_ttft_ratio']:.3f} peak_pages_ratio={g['peak_pages_ratio']:.3f} "
        f"(token mismatches: {g['token_mismatches']:.0f})"
    )
    healthy = g["token_mismatches"] == 0 and g["peak_pages_lt_unshared"] and g["prefix_hit_rate"] > 0
    return bool(healthy), bool(g["warm_ttft_lt_unshared"])


def _gate_speculative(args, cfg, params, device) -> bool:
    """Plain paged vs speculative decoding on the reference's decode-heavy
    mix: identical greedy tokens and more than one token emitted per verify
    slot-lane (the drafter's tokens are being accepted)."""
    from repro_torch.serve.loadgen import LMLoadConfig, compare_speculative

    load = LMLoadConfig(n_requests=min(args.requests, 16), prompt_lens=(4, 6, 8), new_tokens=(24, 32),
                        seed=args.seed)
    rep = compare_speculative(cfg, params, load, n_slots=args.slots, page_size=args.block_size or 16,
                              draft_k=args.draft_k, device=device)
    g = rep["gate"]
    print(
        f"[serve] speculative: accepted/step={g['accepted_tokens_per_step']:.2f} "
        f"tokens/lane={g['tokens_per_lane']:.2f} hit_rate={g['draft_hit_rate']:.2f} "
        f"tok/s ratio {g['tok_per_s_ratio']:.2f} (token mismatches: {g['token_mismatches']:.0f})"
    )
    return g["token_mismatches"] == 0 and g["tokens_per_lane"] > 1


def _gate_fabric(args, cfg, params, device) -> bool:
    """Kill-one-replica failover on a synchronous N-replica fabric (a fake
    clock: nothing sleeps).  Every request — those stranded on the killed
    replica and requeued included — must emit the exact greedy tokens of a
    1-replica run, and the kill must strand work (``requeued > 0``, one
    death).  On failure the fabric's and every replica's flight recorder are
    dumped to ``flightrec_fabric.json`` / ``flightrec_replica_<name>.json``."""
    from repro_torch.obs import Obs
    from repro_torch.serve.fabric import FabricConfig
    from repro_torch.serve.loadgen import FabricLoadConfig, LMLoadConfig, make_lm_fabric

    load = FabricLoadConfig(lm=LMLoadConfig(n_requests=min(args.requests, 12), prompt_lens=(4, 8, 14),
                                            new_tokens=(8, 16), seed=args.seed))
    kw = dict(n_slots=args.slots, page_size=args.block_size or 16, device=device)

    def submit_all(fab):
        return [fab.submit_lm(tok, mn) for tok, mn in load.lm.request_stream(cfg.vocab_size)]

    oracle_fab, _ = make_lm_fabric(cfg, params, FabricConfig(replicas=1, heartbeat_timeout_s=5.0), load, **kw)
    ofuts = submit_all(oracle_fab)
    oracle_fab.drain()
    oracle = [f.result(timeout=60) for f in ofuts]

    t = {"now": 0.0}
    fab_obs = Obs()
    fab, _ = make_lm_fabric(cfg, params, FabricConfig(replicas=args.replicas, heartbeat_timeout_s=5.0), load,
                            obs=fab_obs, clock=lambda: t["now"], **kw)
    futs = submit_all(fab)
    for _ in range(3):  # let every replica admit + decode a few ticks
        fab.step()
    fab.kill("r0")
    t["now"] += 10.0  # the heartbeat goes stale; the next step drains r0
    fab.drain()
    outs = [f.result(timeout=60) for f in futs]
    mismatches = sum(1 for a, b in zip(oracle, outs) if not np.array_equal(a, b))
    counts = fab_obs.recorder.counts()
    print(f"[serve] fabric: replicas={args.replicas} requeued={fab.requeued_total} dead={fab.dead_total} "
          f"routes={counts.get('route', 0)} (requeue token mismatches: {mismatches})")
    ok = mismatches == 0 and fab.requeued_total > 0 and fab.dead_total == 1
    if not ok:
        fab_obs.recorder.dump_json("flightrec_fabric.json")
        for r in fab.replicas:
            if r.lm is not None:
                r.lm.obs.recorder.dump_json(f"flightrec_replica_{r.name}.json")
        print("[serve] fabric gate FAILED; flight dumps -> flightrec_fabric.json, flightrec_replica_*.json")
    return ok


def _demo_sampling(args, cfg, params, device) -> bool:
    """A short sampled batch through the pool (per-request temperature /
    top-k / seed), run twice: the tokens must reproduce."""
    from repro_torch.serve.engine import ContinuousLMEngine
    from repro_torch.serve.service import LMService

    def run():
        eng = ContinuousLMEngine(cfg, params, n_slots=args.slots, max_len=64, max_prompt_len=24,
                                 paged=args.paged, page_size=args.block_size if args.paged else None,
                                 sampling=True, device=device)
        svc = LMService(eng).warmup()
        rng = np.random.default_rng(args.seed)
        futs = [svc.submit(rng.integers(0, cfg.vocab_size, 8).astype(np.int32), 8,
                           temperature=args.temperature or 0.0, top_k=args.top_k, seed=i) for i in range(4)]
        svc.drain()
        return [f.result(timeout=60).tolist() for f in futs]

    a, b = run(), run()
    print(f"[serve] sampled decode (T={args.temperature}, top_k={args.top_k}): "
          f"sample={a[0][:8]} reproducible={a == b}")
    return a == b


def main(argv=None) -> int:
    """Argparse entry point (see the module docstring for usage)."""
    p = argparse.ArgumentParser(prog="repro_torch.serve.cli", description=__doc__)
    p.add_argument("--smoke", action="store_true",
                   help="reduced config + few requests")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu' — never a silent fallback")
    p.add_argument("--requests", type=int, default=512)
    p.add_argument("--input-dim", type=int, default=128)
    p.add_argument("--backbone", type=int, default=256)
    p.add_argument("--d", type=int, default=512, help="projector/embedding width")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--max-queue", type=int, default=4096)
    p.add_argument("--arrival-rps", type=float, default=None,
                   help="open-loop arrival rate (default: closed-loop burst)")
    p.add_argument("--probe-style", default="vic", choices=["bt", "vic"])
    p.add_argument("--probe-block", type=int, default=None)
    p.add_argument("--pretune", default="off", choices=["off", "analytic", "dry", "measure"],
                   help="warm the repro_torch.tune choices of the serve buckets' probe shapes first")
    p.add_argument("--gate", action="store_true",
                   help="also exit 1 unless micro-batched throughput beats naive (LM: "
                        "continuous batching beats whole-request generate); every run "
                        "exits 1 on a dispatch error, a probe that never fired, a "
                        "non-finite value, or (LM) a token or probe-oracle mismatch")
    p.add_argument("--json", action="store_true", help="dump the full report as JSON")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None,
                   help="serve the embedding model saved there by training (newest committed step)")
    # token-model path
    p.add_argument("--lm-arch", default=None,
                   help="serve a token model instead: any arch of repro_torch.configs.list_archs(), reduced "
                        "(--continuous: every arch but musicgen-large; --paged: not rwkv6-3b)")
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--new-tokens", type=int, default=8)
    p.add_argument("--continuous", action="store_true",
                   help="with --lm-arch: continuous batching vs whole-request generate "
                        "on a mixed-length workload")
    p.add_argument("--slots", type=int, default=8, help="continuous-batching decode slot pool size")
    p.add_argument("--paged", action="store_true",
                   help="with --continuous: paged (block-table) KV cache; also holds it "
                        "against the dense pool (tokens, peak cache bytes)")
    p.add_argument("--block-size", type=int, default=None,
                   help="KV page size in tokens (default: auto_page_size's pick for the pool; the paged, "
                        "prefix, speculative and fabric comparisons take 16)")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="with --paged: also serve the mix with long prompts prefilled N tokens "
                        "a tick (tokens reported against the dense pool)")
    p.add_argument("--prefix-cache", action="store_true",
                   help="with --paged: also hold the prefix radix cache against unshared paging "
                        "(identical tokens, fewer peak pages, hits; warm TTFT under --gate)")
    p.add_argument("--speculative", action="store_true",
                   help="with --paged: also hold speculative decoding against plain paged "
                        "decoding (identical tokens, > 1 token a verify lane)")
    p.add_argument("--draft-k", type=int, default=4,
                   help="speculative draft tokens proposed per verify tick")
    p.add_argument("--fabric", action="store_true",
                   help="with --continuous: also gate the replica-router failover path (kill one replica "
                        "mid-decode on a fake clock; requeued requests must emit a 1-replica run's tokens)")
    p.add_argument("--replicas", type=int, default=2, help="fabric size for --fabric")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="run a sampled batch after the greedy checks (0 = greedy only)")
    p.add_argument("--top-k", type=int, default=None,
                   help="restrict sampled decoding to the k highest logits")
    # telemetry (repro_torch.obs)
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve /metrics over HTTP after the run and self-scrape it (0 = ephemeral port); "
                        "unhealthy if any metrics() key is missing from the exposition")
    p.add_argument("--trace-out", default=None, help="write the Chrome trace_event JSON of the run here")
    p.add_argument("--metrics-out", default=None, help="write the final Prometheus exposition text here")
    p.add_argument("--flight-out", default=None, help="write the flight recorder's event ring as JSON here")
    p.add_argument("--profile-dir", default=None, help="capture a torch.profiler trace of the run into this dir")
    p.add_argument("--alerts", default=None,
                   help="alert rules as a JSON file path or inline JSON list (default: the built-in serve rules)")
    args = p.parse_args(argv)
    if args.fabric and not (args.lm_arch and args.continuous):
        p.error("--fabric routes continuous LM replicas; it requires --lm-arch and --continuous")
    if args.prefix_cache and not args.paged:
        p.error("--prefix-cache shares KV pages; it requires --paged")
    if args.speculative and not args.paged:
        p.error("--speculative verifies through scratch pages; it requires --paged")
    if args.prefill_chunk and not args.paged:
        p.error("--prefill-chunk rides the paged machinery; it requires --paged")

    if args.smoke:
        args.requests = min(args.requests, 192)
        args.input_dim, args.backbone, args.d = 32, 64, 256
        args.max_batch = min(args.max_batch, 32)
        if args.lm_arch and args.continuous:
            args.requests = min(args.requests, 24)
    if args.lm_arch:
        return _run_lm(args)
    return _run_embedding(args)


if __name__ == "__main__":
    sys.exit(main())
