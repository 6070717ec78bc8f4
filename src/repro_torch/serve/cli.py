"""Serve CLI: load-generate against the embedding service and print the
scrape metrics (port of the embedding path of ``repro/serve/cli.py``).

    # reduced end-to-end smoke: naive vs micro-batched + probes, on the CPU
    PYTHONPATH=src python -m repro_torch.serve.cli --smoke --device cpu

    # the ssl-paper width on the GPU, grouped probe at the paper's b = 128
    PYTHONPATH=src python -m repro_torch.serve.cli --d 2048 --max-batch 256 \
        --probe-block 128

The token-model paths (``--lm-arch``, continuous batching, paging, the
fabric), pre-tuning and telemetry belong to later slices of the port.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


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
        model = init_ssl_model(model_cfg, seed=args.seed)
        return ServeEngine(model_cfg, model, policy=policy, device=device)

    probe_cfg = DecorrConfig(style=args.probe_style, reg="sum", q=2, block_size=args.probe_block)
    return policy, engine_fn, lambda: DecorrProbe(probe_cfg, device=device)


def _run_embedding(args) -> int:
    from repro_torch.serve.buckets import bucket_sizes
    from repro_torch.serve.loadgen import LoadConfig, compare_policies

    policy, engine_fn, probe_fn = _build(args)
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
    report = compare_policies(engine_fn, load, policy, probe_fn=probe_fn)
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
    healthy = (
        m["dispatch_errors"] == 0
        and m["decorr_probe_steps"] > 0
        and bool(np.all(np.isfinite(rows)))
        and all(np.isfinite(v) for k, v in m.items() if k.startswith("decorr_"))
    )
    print(f"[serve] healthy={healthy} (no dispatch error, probe fired, finite rows and probes)")
    if not healthy:
        return 1
    return 0 if g["microbatch_beats_naive"] or not args.gate else 1


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
    p.add_argument("--gate", action="store_true",
                   help="also exit 1 unless micro-batched throughput beats naive "
                        "(every run exits 1 on a dispatch error, a probe that never "
                        "fired, or a non-finite row or probe value)")
    p.add_argument("--json", action="store_true", help="dump the full report as JSON")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.smoke:
        args.requests = min(args.requests, 192)
        args.input_dim, args.backbone, args.d = 32, 64, 256
        args.max_batch = min(args.max_batch, 32)
    return _run_embedding(args)


if __name__ == "__main__":
    sys.exit(main())
