#!/usr/bin/env python3
"""GPU smoke of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check exits non-zero and prints no result):

  0. build — compiles every CUDA source of ``repro_torch/kernels/csrc`` into
     ``build/kernels/`` (one ``nvcc`` per source, all started together).
  1. kernels vs plain — each hand-written kernel (cmatmul, ctwiddle,
     pmatmul, freq_outer) runs at the serving path's shapes (d = 2048 and
     8192, b = 128, n = 256; the prime d = 2039 for the padded plan's q = 1
     inverse path) and is held against its plain PyTorch version on the same
     inputs.  Prints max error, kernel / plain / library time and the bound.
  2. the service — ``EmbeddingService`` at the full ``ssl-paper`` width
     (3072 -> 512 -> 512 -> 2048 -> 2048 -> 2048, random weights from a
     seed, buckets up to 256) serves 512 seeded requests twice: probe
     ungrouped (Eq. 6, four-step kernels), then b = 128 (Eq. 13, grouped
     kernels), style 'vic', q = 2.  Embeddings are checked against the CPU
     forward, the last probe window against the plain route on the card,
     ``dispatch_errors`` must be 0 and every kernel of the run's path must
     have launched (counters cleared just before each run).
  3. profile — the same two service runs, warmed, under ``torch.profiler``:
     wall time vs summed device time (the device's idle share) and the
     device work by kernel name.
  4. report — one JSON ``kernels`` line, the card's name and power limit,
     and the last line ``{"ok": true, "device": {...}}``.

Times are CUDA-event means over repeated launches with inputs resident in
L2 where they fit (the service finds them warm: each stage reads what the
previous one just wrote); they include the host's launch cost when the
host, not the device, is the slower side.  "device-only" times sum the
durations of the device work per call from a profiler (CUPTI) trace.  ``bound_ms`` is the larger of bytes / 3.35 TB/s
and f32 operations / 67 TFLOP/s (H100 SXM data sheet, non-tensor-core f32),
counting each input read once and each output written once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# kernel vs its plain version: the reference's kernel tolerance (2e-4),
# taken relative to the output's largest magnitude — both sum in f32, in a
# different order, over contractions of up to 512 terms
KERNEL_TOL = 2e-4
# served embeddings vs the CPU forward: cuBLAS f32 (TF32 off) and the CPU
# BLAS sum 3072-term products in different orders
EMBED_TOL = 1e-4
# probe on the kernel route vs the plain torch.fft route: the reference's
# loss tolerance (5e-4 relative)
PROBE_TOL = 5e-4
N_REQUESTS = 512
SEED = 0

REPLACES = {
    "cmatmul": "src/repro/kernels/sumvec_fft/kernel.py:54",
    "ctwiddle": "src/repro/kernels/sumvec_fft/kernel.py:131",
    "pmatmul": "src/repro/kernels/grouped_sumvec/kernel.py:49",
    "freq_outer": "src/repro/kernels/grouped_sumvec/kernel.py:115",
}
SOURCES = {
    "cmatmul": "src/repro_torch/kernels/csrc/sumvec_fft.cu",
    "ctwiddle": "src/repro_torch/kernels/csrc/sumvec_fft.cu",
    "pmatmul": "src/repro_torch/kernels/csrc/grouped_sumvec.cu",
    "freq_outer": "src/repro_torch/kernels/csrc/grouped_sumvec.cu",
}


def _time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_events(fn):
    """Device-side events (kernels, copies) of one call of ``fn`` under the
    profiler (CUPTI), as (name, microseconds) pairs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.device_time_total) for e in prof.events() if e.device_type == DeviceType.CUDA]


def _device_ms(fn, iters: int = 20):
    """Mean device time per call of ``fn``: the summed durations of the
    device work it enqueues (None if the profiler saw no device events)."""
    fn()
    events = _device_events(lambda: [fn() for _ in range(iters)])
    return sum(us for _, us in events) / iters / 1e3 if events else None


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.5f}"


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_err(got, want) -> tuple:
    """(max abs error, that error relative to max(1, max |want|))."""
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    err = max(float((g - w).abs().max()) for g, w in pairs)
    scale = max(1.0, max(float(w.abs().max()) for _, w in pairs))
    return err, err / scale


class Phase:
    """Collects failures; a phase that raises is recorded, not fatal to the others."""

    def __init__(self):
        self.failures = []

    def check(self, ok: bool, what: str):
        if not ok:
            self.failures.append(what)
            print(f"[chip_smoke] FAIL {what}", flush=True)

    def run(self, name: str, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # a phase boundary: record, report, go on
            traceback.print_exc()
            self.failures.append(f"{name} raised")
            print(f"[chip_smoke] FAIL {name} raised", flush=True)
            return None
        print(f"[chip_smoke] phase {name}: {time.perf_counter() - t0:.1f}s", flush=True)
        return out


# ---------------------------------------------------------------------------
# phase 1: every kernel against its plain version
# ---------------------------------------------------------------------------


def _kernel_cases(dev):
    """(kernel, label, kernel fn, plain fn, library fn, bytes, flops) at the
    serving path's shapes."""
    import torch

    from repro_torch.kernels.grouped_sumvec import kernel as gk
    from repro_torch.kernels.sumvec_fft import kernel as fk
    from repro_torch.kernels.sumvec_fft.ops import fft_plan
    from repro_torch.kernels.utils import dft_matrices, full_dft_matrices

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    rand = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
    n, b = 256, 128
    cases = []

    def cmm(label, m, k, nn, real_a, sign=-1):
        br, bi = full_dft_matrices(k, sign, dev)  # (k, k): every case has k == nn
        ar = rand(m, k)
        ai = None if real_a else rand(m, k)
        ac = torch.complex(ar, torch.zeros_like(ar) if ai is None else ai)
        bc = torch.complex(br, bi)
        nbytes = 4 * (m * k * (1 if real_a else 2) + 2 * k * nn + 2 * m * nn)
        flops = (4 if real_a else 8) * m * k * nn
        cases.append((
            "cmatmul", label,
            lambda: fk.cmatmul(ar, ai, br, bi),
            lambda: fk.cmatmul_plain(ar, ai, br, bi),
            lambda: ac @ bc,
            nbytes, flops,
        ))

    def ctw(label, rows, d):
        xr, xi, wr, wi = rand(rows, d), rand(rows, d), rand(d), rand(d)
        xc, wc = torch.complex(xr, xi), torch.complex(wr, wi)
        cases.append((
            "ctwiddle", label,
            lambda: fk.ctwiddle(xr, xi, wr, wi),
            lambda: fk.ctwiddle_plain(xr, xi, wr, wi),
            lambda: xc * wc,
            4 * (4 * rows * d + 2 * d), 6 * rows * d,
        ))

    def pmm(label, m, k, nn, basis=None):
        a = rand(m, k)
        bmat = rand(k, nn) if basis is None else basis
        cases.append((
            "pmatmul", label,
            lambda: gk.pmatmul(a, bmat),
            lambda: gk.pmatmul_plain(a, bmat),
            lambda: torch.matmul(a, bmat),
            4 * (m * k + k * nn + m * nn), 2 * m * k * nn,
        ))

    def fo(label, f, k, nn):
        a, bb = rand(f, k, nn), rand(f, k, nn)
        cases.append((
            "freq_outer", label,
            lambda: gk.freq_outer(a, bb),
            lambda: gk.freq_outer_plain(a, bb),
            lambda: torch.bmm(a.mT, bb),
            4 * (2 * f * k * nn + f * nn * nn), 2 * f * k * nn * nn,
        ))

    nf = b // 2 + 1
    cr, ci = dft_matrices(b, dev)
    block_basis = torch.cat([cr, ci], dim=1).contiguous()
    for d in (2048, 8192):
        p = fft_plan(d)
        cmm(f"d={d} stage1 ({n * p.d2},{p.d1})x({p.d1},{p.d1}) real A", n * p.d2, p.d1, p.d1, True)
        ctw(f"d={d} twiddle ({n},{d})", n, d)
        cmm(f"d={d} stage3 ({n * p.d1},{p.d2})x({p.d2},{p.d2})", n * p.d1, p.d2, p.d2, False)
        nb = d // b
        pmm(f"d={d} block DFT ({n * nb},{b})x({b},{2 * nf})", n * nb, b, 2 * nf, block_basis)
        fo(f"d={d} freq_outer ({nf},{2 * n},{nb})", nf, 2 * n, nb)
        pmm(f"d={d} q=1 synthesis ({nb * nb},{nf})x({nf},{b})", nb * nb, nf, b)
    p = fft_plan(2039)  # prime: padded plan, q = 1 needs the inverse pipeline
    cmm(f"d=2039 dp={p.dp} stage1 ({n * p.d2},{p.d1})x({p.d1},{p.d1}) real A", n * p.d2, p.d1, p.d1, True)
    ctw(f"d=2039 dp={p.dp} twiddle ({n},{p.dp})", n, p.dp)
    cmm(f"d=2039 dp={p.dp} stage3 ({n * p.d1},{p.d2})x({p.d2},{p.d2})", n * p.d1, p.d2, p.d2, False)
    cmm(f"d=2039 inverse ({p.d1},{p.d2})x({p.d2},{p.d2})", p.d1, p.d2, p.d2, False, sign=1)
    ctw(f"d=2039 inverse twiddle (1,{p.dp})", 1, p.dp)
    cmm(f"d=2039 inverse ({p.d2},{p.d1})x({p.d1},{p.d1})", p.d2, p.d1, p.d1, False, sign=1)
    return cases


# the case whose numbers stand for each kernel in the JSON line: the main
# path's shape at the served width d = 2048
JSON_CASE = {
    "cmatmul": "d=2048 stage3",
    "ctwiddle": "d=2048 twiddle",
    "pmatmul": "d=2048 block DFT",
    "freq_outer": "d=2048 freq_outer",
}


def phase_kernels(ph: Phase, dev):
    import torch

    rows = {}
    for name, label, kern, plain, lib, nbytes, flops in _kernel_cases(dev):
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err, rel = _max_err(got, want)
        ph.check(rel <= KERNEL_TOL, f"{name} [{label}] rel err {rel:.3g} > {KERNEL_TOL}")
        k_ms = _time_ms(kern)
        p_ms = _time_ms(plain)
        l_ms = _time_ms(lib)
        b_ms, by = _bound(nbytes, flops)
        print(
            f"[kernel] {name:<10} {label}: max_abs_err={err:.3g} rel={rel:.3g} "
            f"kernel_ms={k_ms:.5f} plain_ms={p_ms:.5f} library_ms={l_ms:.5f} "
            f"bound_ms={b_ms:.5f} ({by}) | device-only ms: kernel={_fmt(_device_ms(kern))} "
            f"plain={_fmt(_device_ms(plain))} library={_fmt(_device_ms(lib))}",
            flush=True,
        )
        if label.startswith(JSON_CASE[name]):
            rows[name] = {
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "shape": label, "max_abs_err": err,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
                "library_ms": l_ms,
            }
    return rows


# ---------------------------------------------------------------------------
# phase 2: the embedding service at the ssl-paper width
# ---------------------------------------------------------------------------


def _paper():
    """(model config, bucket policy) of ``configs/ssl_paper``: full widths,
    buckets up to the paper's batch size."""
    from repro_torch.configs import ssl_paper
    from repro_torch.serve.buckets import BucketPolicy
    from repro_torch.train.ssl import SSLModelConfig

    paper = ssl_paper.config()
    model_cfg = SSLModelConfig(paper.input_dim, paper.backbone_widths, paper.projector_widths)
    return model_cfg, BucketPolicy(max_batch=paper.batch_size)


def _serve_once(ph: Phase, dev, block_size, expect):
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.decorr.probe import probe_metrics
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.loadgen import LoadConfig, request_stream, run_microbatched
    from repro_torch.serve.probes import DecorrProbe
    from repro_torch.serve.service import EmbeddingService
    from repro_torch.train.ssl import init_ssl_model

    tag = f"probe block={block_size}"
    model_cfg, policy = _paper()
    cfg = DecorrConfig(style="vic", reg="sum", q=2, block_size=block_size)
    load = LoadConfig(n_requests=N_REQUESTS, input_dim=model_cfg.input_dim, seed=SEED)

    kernels.reset_launch_counts()
    engine = ServeEngine(model_cfg, init_ssl_model(model_cfg, seed=SEED), policy=policy, device=dev)
    probe = DecorrProbe(cfg, perm_seed=SEED, device=dev)
    service = EmbeddingService(engine, policy=policy, probe=probe).start()
    try:
        summary = run_microbatched(service, load)
        metrics = service.metrics()
    finally:
        service.stop()
    counts = kernels.launch_counts()
    print(f"[serve] {tag}: launches {counts}", flush=True)
    for name in expect:
        ph.check(counts[name] > 0, f"{tag}: kernel {name} never launched on the main path")
    ph.check(metrics["dispatch_errors"] == 0, f"{tag}: dispatch_errors={metrics['dispatch_errors']}")
    ph.check(metrics["decorr_probe_steps"] == N_REQUESTS // 256,
             f"{tag}: probe fired {metrics['decorr_probe_steps']} times")

    rows = summary.pop("rows")
    ph.check(rows.shape == (N_REQUESTS, engine.d) and bool(np.all(np.isfinite(rows))),
             f"{tag}: served rows not finite of shape ({N_REQUESTS}, {engine.d})")
    # embeddings vs the plain route on the CPU (same seed -> same weights)
    xs, _ = request_stream(load)
    with torch.no_grad():
        want = init_ssl_model(model_cfg, seed=SEED)(torch.from_numpy(xs)).numpy()
    e_err = float(np.max(np.abs(rows - want)))
    e_rel = e_err / max(1.0, float(np.max(np.abs(want))))
    ph.check(e_rel <= EMBED_TOL, f"{tag}: embeddings vs CPU rel err {e_rel:.3g} > {EMBED_TOL}")

    # the last probe window (step 1: rows 256..511) on the plain route, on the card
    window = torch.from_numpy(rows[256:512]).to(dev)
    perm = probe.permutation(1, engine.d)
    plain = {k: float(v) for k, v in probe_metrics(window, None, cfg, perm, impl="plain").items()}
    worst = 0.0
    for k, v in plain.items():
        got = metrics[f"decorr_{k}"]
        rel = abs(got - v) / max(abs(v), 1e-12)
        worst = max(worst, rel)
        ph.check(rel <= PROBE_TOL, f"{tag}: probe {k} kernel {got!r} vs plain {v!r} (rel {rel:.3g})")

    # one probe update, kernel route vs plain route, on the same window; one
    # 256-row encode (host rows in, as the dispatch loop does it)
    k_ms = _time_ms(lambda: probe_metrics(window, None, cfg, perm), iters=20)
    p_ms = _time_ms(lambda: probe_metrics(window, None, cfg, perm, impl="plain"), iters=20)
    enc_ms = _time_ms(lambda: engine.encode(xs[:256]), iters=20)
    print(
        f"[serve] {tag}: {N_REQUESTS} requests p50={summary['p50_ms']:.3f}ms "
        f"p99={summary['p99_ms']:.3f}ms throughput={summary['throughput_rps']:.1f} req/s "
        f"mean_batch={summary['mean_batch']:.1f} embed_rel_err={e_rel:.3g} "
        f"probe_worst_rel_err={worst:.3g} r_sum={metrics['decorr_r_sum']:.6g} "
        f"probe_update_ms kernel={k_ms:.4f} plain={p_ms:.4f} encode256_ms={enc_ms:.4f} "
        f"wall_s={summary['wall_s']:.4f} batches={summary['batches']:.0f}",
        flush=True,
    )
    return counts


def _profile_once(dev, block_size):
    """Serve 512 requests on a warmed service under the profiler: wall time
    vs summed device time, and the device work by kernel name."""
    import time as _time

    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.loadgen import LoadConfig, request_stream
    from repro_torch.serve.probes import DecorrProbe
    from repro_torch.serve.service import EmbeddingService
    from repro_torch.train.ssl import init_ssl_model

    model_cfg, policy = _paper()
    cfg = DecorrConfig(style="vic", reg="sum", q=2, block_size=block_size)
    xs, _ = request_stream(LoadConfig(n_requests=N_REQUESTS, input_dim=model_cfg.input_dim, seed=SEED + 1))
    engine = ServeEngine(model_cfg, init_ssl_model(model_cfg, seed=SEED), policy=policy, device=dev)
    service = EmbeddingService(engine, policy=policy, probe=DecorrProbe(cfg, device=dev))
    service.warmup().start()
    wall = [0.0]

    def serve():
        t0 = _time.perf_counter()
        futures = [service.submit(x, block=True, timeout=60) for x in xs]
        for f in futures:
            f.result(timeout=60)
        wall[0] = _time.perf_counter() - t0

    try:
        events = _device_events(serve)
    finally:
        service.stop()
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    tops = "; ".join(f"{n[:60]}={us / 1e3:.4f}ms" for n, us in top)
    # this package's kernels (their device names end in <kernel>_kernel)
    ours = {
        k: sum(us for n, us in events if f"{k}_kernel" in n) / 1e3 for k in REPLACES
    }
    wall_ms = wall[0] * 1e3
    print(
        f"[profile] probe block={block_size}: {N_REQUESTS} requests wall_ms={wall_ms:.3f} "
        f"device_busy_ms={busy_ms:.4f} idle_share={1 - busy_ms / wall_ms:.4f} "
        f"device events={len(events)} | ported kernels ms: "
        + " ".join(f"{k}={v:.4f}" for k, v in ours.items())
        + f" | top: {tops}",
        flush=True,
    )


def phase_profile(dev):
    for block in (None, 128):
        _profile_once(dev, block)


def phase_service(ph: Phase, dev):
    totals = {}
    for block, expect in ((None, ("cmatmul", "ctwiddle")), (128, ("pmatmul", "freq_outer"))):
        counts = _serve_once(ph, dev, block, expect)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    return totals


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch import resolve_device
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing next to this script ({e})", file=sys.stderr)
        return 1

    dev = resolve_device("cuda")  # also pins TF32 off for cuBLAS and cuDNN
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    ph = Phase()
    built = ph.run("build", build.build_all)
    if built is None:
        return 1
    rows = ph.run("kernels", phase_kernels, ph, dev) or {}
    launches = ph.run("service", phase_service, ph, dev) or {}
    ph.run("profile", phase_profile, dev)
    for name in REPLACES:
        ph.check(name in rows, f"no timing row for {name}")
        ph.check(launches.get(name, 0) > 0, f"{name} never launched on the main path")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    ph.check(smi.returncode == 0, "nvidia-smi failed")
    if ph.failures:
        print(f"[chip_smoke] {len(ph.failures)} check(s) failed: {ph.failures}", flush=True)
        return 1
    line = [dict(rows[name], launches=launches[name]) for name in REPLACES]
    print(json.dumps({"kernels": line}))
    print(smi.stdout.strip().splitlines()[0])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
