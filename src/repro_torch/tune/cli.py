"""Offline pre-tuner: ``python -m repro_torch.tune.cli --dry --arch ssl-paper``
(port of ``repro/tune/cli.py``).

Derives the kernel shapes one regularizer call of an architecture config
reaches (batch x projector width, the four-step inner products from the
tuned FFT plan, the grouped pipeline at the searched or pinned block size),
tunes each, and persists the winners to the JSON cache so training and
serving start warm.

    python -m repro_torch.tune.cli --dry --arch ssl-paper         # counted FLOPs, CPU
    python -m repro_torch.tune.cli --measure --arch ssl-paper     # timed on the card
    python -m repro_torch.tune.cli --analytic --shape 256x2048    # instant, model only
    python -m repro_torch.tune.cli --dry --serve --shape 64x2048  # serve bucket ladder,
                                                                  # forward-only shapes

``--measure`` times on ``--device`` (``cuda`` unless ``cpu`` is passed; it
raises where CUDA is absent); ``--cache-dir`` points the cache elsewhere
(``REPRO_TUNE_CACHE``).  The six tile kernels report "kept default": their
one config is the tile their C entry uses (``repro_torch/tune/__init__.py``).
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from typing import List, Tuple

ARCHS = {
    "ssl-paper": "repro_torch.configs.ssl_paper",
}


def arch_shapes(name: str) -> List[Tuple[int, int]]:
    """(batch, width) pairs for a registered architecture config."""
    import importlib

    cfg = importlib.import_module(ARCHS[name]).config()
    n = int(cfg.batch_size)
    return [(n, d) for d in sorted({int(w) for w in cfg.projector_widths})]


def jobs_for(n: int, d: int, block_size=None, forward_only=False, **tune_kw):
    """All tunable kernel shapes reached from one (n, d) regularizer call,
    forward and backward (training launches the vjp shapes too).

    ``block_size``: the grouped b the caller will use; ``None`` searches b
    itself (``grouped_block_plan``) and the winner drives the grouped shapes
    — b is part of the loss, so accuracy-pinned configs pass it.
    ``forward_only`` drops the vjp shapes (the serve probes never
    differentiate).  The four-step shapes depend on the FFT plan, so the
    plans are tuned first and the shapes read off the winners.  Returns
    ([plan TuneResults], remaining (kernel, shape) jobs).
    """
    from repro_torch import tune

    plans = [tune.tune("sumvec_fft_plan", (d,), **tune_kw)]
    dp, d1, d2 = (plans[0].best[k] for k in ("dp", "d1", "d2"))
    if block_size:
        b = min(int(block_size), d)
    else:
        plans.append(tune.tune("grouped_block_plan", (n, d), **tune_kw))
        b = int(plans[-1].best["b"])
    nb = math.ceil(d / b)
    nf = b // 2 + 1
    jobs = [
        ("xcorr_offdiag", (n, d)),
        # four-step forward: step-1 / step-3 complex products + twiddle
        ("cmatmul", (n * d2, d1, d1)),
        ("cmatmul", (n * d1, d2, d2)),
        ("ctwiddle", (n, dp)),
        # inverse four-step (padded plans and q = 1): batch-1 accumulator
        ("cmatmul", (d1, d2, d2)),
        ("cmatmul", (d2, d1, d1)),
        ("ctwiddle", (1, dp)),
        # grouped pipeline: block DFT forward + pairwise stage
        ("pmatmul", (n * nb, b, 2 * nf)),
        ("pmatmul", (nb * nb, nf, b)),  # q = 1 synthesis
        ("freq_outer", (nf, 2 * n, nb)),
        ("freq_mat", (nf, 2 * n, nb, nb)),
    ]
    if not forward_only:
        jobs += [
            # four-step vjp: dB = A^H @ g
            ("cmatmul", (d1, n * d2, d1)),
            ("cmatmul", (d2, n * d1, d2)),
            # grouped block-DFT vjp pair
            ("pmatmul", (n * nb, 2 * nf, b)),
            ("pmatmul", (b, n * nb, 2 * nf)),
        ]
    seen, uniq = set(), []
    for kernel, shape in jobs:
        key = (kernel, tune.canonical_shape(kernel, shape))
        if key not in seen:
            seen.add(key)
            uniq.append((kernel, shape))
    return plans, uniq


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="repro_torch.tune.cli", description=__doc__)
    p.add_argument("--arch", choices=sorted(ARCHS), help="architecture config to pre-tune")
    p.add_argument("--shape", action="append", default=[], metavar="NxD",
                   help="explicit (batch x width) shape, repeatable (e.g. 256x2048)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--dry", action="store_true", help="rank by counted FLOPs of the plain route (default)")
    mode.add_argument("--measure", action="store_true", help="rank by measured time on --device")
    mode.add_argument("--analytic", action="store_true", help="rank by the closed-form model only")
    p.add_argument("--max-candidates", type=int, default=6, help="evaluate at most K candidates")
    p.add_argument("--block-size", type=int,
                   help="grouped-regularizer b your config uses (default: search grouped_block_plan for it)")
    p.add_argument("--serve", action="store_true",
                   help="pre-tune the SERVE bucket shapes instead: each (n, d) becomes the micro-batcher's "
                        "bucket ladder (align .. n rows, width d), forward only")
    p.add_argument("--serve-align", type=int, default=None, help="bucket granularity for --serve (default 8)")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="batch-shard count: tune the SHARD-LOCAL rows (n / data_parallel)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="feature-shard count for the engine's tp mode (rows n / (dp * mp))")
    p.add_argument("--distributed", default=None, choices=["local", "global", "tp"],
                   help="engine mode the shard-local shapes are for (default: tp when --model-parallel > 1, "
                        "else global)")
    p.add_argument("--device", default=None, help="where --measure times: 'cuda' (default) or 'cpu'")
    p.add_argument("--cache-dir", help="override the JSON cache directory (REPRO_TUNE_CACHE)")
    p.add_argument("--no-persist", action="store_true", help="search but do not write the cache")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    if args.cache_dir:
        os.environ["REPRO_TUNE_CACHE"] = args.cache_dir
    mode_s = "measure" if args.measure else "analytic" if args.analytic else "dry"

    shapes: List[Tuple[int, int]] = []
    for spec in args.shape:
        n_s, _, d_s = spec.lower().partition("x")
        try:
            shapes.append((int(n_s), int(d_s)))
        except ValueError:
            p.error(f"--shape wants NxD (e.g. 256x2048), got {spec!r}")
    if args.arch:
        shapes.extend(arch_shapes(args.arch))
    if not shapes:
        p.error("nothing to tune: pass --arch and/or --shape NxD")
    if args.serve:
        from repro_torch.serve.buckets import BucketPolicy, bucket_shapes

        expanded = []
        for n, d in shapes:
            expanded.extend(bucket_shapes(BucketPolicy(max_batch=n, align=args.serve_align or BucketPolicy().align), d))
        shapes = sorted(set(expanded))
    if args.data_parallel > 1 or args.model_parallel > 1:
        from repro_torch.decorr.config import DecorrConfig
        from repro_torch.decorr.warmup import shard_local_shape

        dist = args.distributed or ("tp" if args.model_parallel > 1 else "global")
        cfg = DecorrConfig(distributed=dist)
        shapes = [shard_local_shape(n, d, cfg, data_parallel=args.data_parallel,
                                    model_parallel=args.model_parallel) for n, d in shapes]

    from repro_torch import tune
    from repro_torch.tune import cache as tcache

    tune_kw = dict(mode=mode_s, max_candidates=args.max_candidates, persist=not args.no_persist,
                   device=args.device)

    def report(res):
        moved = "tuned" if res.best != res.default else "kept default"
        line = f"{res.kernel:>18} {'x'.join(map(str, res.shape)):>18}  {moved}: {res.best}"
        if res.cached:
            line += f"  (cached, {res.mode})"
        if args.verbose:
            for c in sorted(res.candidates, key=lambda c: c.cost["flops"]):
                t = f" time_us={c.time_us:.2f}" if c.time_us is not None else ""
                line += (f"\n{'':>40}{c.config}  flops={c.cost['flops']:.3e} "
                         f"bytes={c.cost['hbm_bytes']:.3e}{t}")
        print(line, flush=True)

    n_jobs = 0
    for n, d in shapes:
        plans, jobs = jobs_for(n, d, block_size=args.block_size, forward_only=args.serve, **tune_kw)
        for plan_result in plans:
            report(plan_result)
            n_jobs += 1
        for kernel, shape in jobs:
            report(tune.tune(kernel, shape, **tune_kw))
            n_jobs += 1
    where = tcache.cache_dir() if not args.no_persist else "(not persisted)"
    print(f"# tuned {n_jobs} kernel shapes in {mode_s} mode -> {where}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
