#!/usr/bin/env python3
"""A / B timing of the port's CUDA kernels across checkouts, on one card.

    python3 tools/kernel_ab.py [--out FILE] [--kernels a,b] [--no-train] [--no-host] [--no-lm] TREE [TREE ...]

Each TREE is the root of a checkout (it holds ``chip_smoke.py`` and
``src/repro_torch``), e.g. the parent commit unpacked with ``git archive``
into a git-ignored directory.  The trees run one after another, each in a
process of its own that imports that tree's package and ``chip_smoke.py``
and builds its kernels into that tree's ``build/kernels``; give them in
turns (parent, change, change, parent) so that drift on the card shows.
Per tree it prints JSON lines:

  * ``case``: every phase-1 case of ``chip_smoke._kernel_cases`` (of the
    kernels named by ``--kernels``, default all): kernel, plain and library
    event ms (CUDA events over 50 back-to-back calls: the host's launch cost
    where that is the slower side) and device ms (summed CUPTI kernel time),
    and the kernel's device ms with the L2 cache flushed before each call
    (``cold_dev_ms``: a 128 MB device-to-device copy, left out of the sum),
    as a caller whose inputs were evicted finds it (an LM decode tick's KV
    pages);
  * ``host`` (unless ``--no-host``): the host's cost per call of each segment
    of the launch chain of ``ctwiddle`` at (256, 2048) and ``pmatmul`` at
    (4096, 128) x (128, 130), from ``time.perf_counter_ns`` over 2000 calls
    (the queue drained between batches of 200, outside the clock);
  * ``train`` (unless ``--no-train``): median step ms of train arms (a),
    (b) and (c) of ``chip_smoke.py`` on the kernel route and on the plain
    route, 20 steps each, the first 5 left out;
  * ``lm`` (unless ``--no-lm``): the bf16 gemma2-2b run of ``chip_smoke.py``
    phase 5 (``_lm_timed``): its profiled window of decode ticks, read from
    the tree's own ``[profile] lm`` and ``[lm] bf16 timed`` lines —
    ``paged_attention`` device ms, device busy ms, decode tick median ms.

Needs a CUDA card and ``nvcc``; exits 1 without one.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

HOST_CALLS, HOST_BATCH = 2000, 200


def _host_us(fn) -> float:
    """Host microseconds per call of ``fn``: HOST_CALLS calls in batches of
    HOST_BATCH, the device queue drained between batches off the clock."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    total = 0
    for _ in range(HOST_CALLS // HOST_BATCH):
        t0 = time.perf_counter_ns()
        for _ in range(HOST_BATCH):
            fn()
        total += time.perf_counter_ns() - t0
        torch.cuda.synchronize()
    return total / HOST_CALLS / 1e3


def _cold_ms(fn, flush, iters: int = 20):
    """Device ms of ``fn`` a call with the L2 cache flushed before each by a
    copy between the two ``flush`` buffers (not counted), or None if the
    profiler saw nothing."""
    import chip_smoke as cs

    fn()
    events = cs._device_events(lambda: [(flush[0].copy_(flush[1]), fn()) for _ in range(iters)])
    own = [us for name, us in events if "memcpy" not in name.lower()]
    return sum(own) / iters / 1e3 if own else None


def _guard(dev) -> None:
    import torch

    with torch.cuda.device(dev):
        pass


def _host_segments(dev):
    """{segment: host us per call} for the launch chains of ctwiddle and pmatmul."""
    import torch

    from repro_torch.kernels import build, count_launch
    from repro_torch.kernels.grouped_sumvec import kernel as gk
    from repro_torch.kernels.sumvec_fft import kernel as fk
    from repro_torch.kernels.utils import check_operand, route

    gen = torch.Generator().manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
    out = {}
    n, d = 256, 2048
    xr, xi, wr, wi = rand(n, d), rand(n, d), rand(d), rand(d)
    w_conj = (wr, (-wi).contiguous())
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    m, k, nn = 4096, 128, 130
    a, b = rand(m, k), rand(k, nn)
    c = torch.empty(m, nn, device=dev)
    chains = {
        "ctwiddle": (fk.ctwiddle, lambda: fk.ctwiddle(xr, xi, wr, wi, w_conj), lambda: fk._ctwiddle_launch(xr, xi, wr, wi),
                     ("sumvec_fft", "ctwiddle", (xr, xi, wr, wi, yr, yi, n, d)),
                     lambda: (route(xr, xi, wr, wi), check_operand("x", xr, (n, d)), check_operand("x", xi, (n, d)),
                              check_operand("w", wr, (d,)), check_operand("w", wi, (d,))),
                     lambda: (torch.empty_like(xr), torch.empty_like(xi))),
        "pmatmul": (gk.pmatmul, lambda: gk.pmatmul(a, b), lambda: gk._pmatmul_launch(a, b),
                    ("grouped_sumvec", "pmatmul", (a, b, c, m, k, nn)),
                    lambda: (route(a, b), check_operand("a", a, (m, k)), check_operand("b", b, (k, nn))),
                    lambda: torch.empty((m, nn), dtype=torch.float32, device=dev)),
    }
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    for name, (wrapper, full, launcher, (fam, kname, args), checks, outputs) in chains.items():
        fn = build._function(fam, kname, args)
        ptrs = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in args]
        stream = torch.cuda.current_stream(dev).cuda_stream
        before = wrapper.launches
        seg = {
            "wrapper (autograd.Function apply)": _host_us(full),
            "launcher (checks, outputs, build.launch, count)": _host_us(launcher),
            "build.launch": _host_us(lambda: build.launch(fam, kname, dev, *args)),
            "ctypes call alone": _host_us(lambda: fn(*ptrs, stream)),
            "route + check_operand": _host_us(checks),
            "output allocation": _host_us(outputs),
            "data_ptr list": _host_us(lambda: [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in args]),
            "torch.cuda.device guard": _host_us(lambda: _guard(dev)),
            "torch.cuda.current_stream(dev).cuda_stream": _host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
            "torch._C._cuda_getCurrentRawStream": _host_us(lambda: torch._C._cuda_getCurrentRawStream(index)),
            "torch.cuda.current_device": _host_us(torch.cuda.current_device),
            "count_launch": _host_us(lambda: count_launch(wrapper)),
        }
        wrapper.launches = before
        out[name] = seg
    return out


def _lm_window(cs, dev) -> dict:
    """The tree's phase-5 bf16 run; the numbers of its printed window."""
    import torch

    from repro_torch.serve.loadgen import LMLoadConfig

    load = LMLoadConfig()
    max_len = -(-max(load.max_request_len + 8, 32) // cs.LM_PAGE) * cs.LM_PAGE
    cfg, params = cs._lm_model(dev, torch.bfloat16)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cs._lm_timed(cs.Phase(), cfg, params, dev, load.request_stream(cfg.vocab_size), max_len, max(load.prompt_lens))
    del params
    torch.cuda.empty_cache()
    text = printed.getvalue()
    pick = lambda pattern: float(re.search(pattern, text).group(1))
    return {"paged_attention_ms": pick(r"paged_attention ms=([0-9.]+)"),
            "device_busy_ms": pick(r"\[profile\] lm .*?device_busy_ms=([0-9.]+)"),
            "decode_tick_median_ms": pick(r"decode_tick_ms median=([0-9.]+)")}


def run_one(tree: str, label: str, kernels, train: bool, host: bool, lm: bool) -> int:
    tree = os.path.abspath(tree)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import resolve_device
    from repro_torch.kernels import build

    dev = resolve_device("cuda")
    build.build_all()
    emit = lambda kind, **kw: print(json.dumps(dict(kind=kind, tree=label, **kw)), flush=True)
    emit("device", name=torch.cuda.get_device_name(0), torch=torch.__version__)
    flush = torch.zeros((2, 32 << 20), dtype=torch.float32, device=dev)  # 2 x 128 MB, over the 50 MB L2
    for name, case_label, kern, plain, lib, nbytes, flops in cs._kernel_cases(dev):
        if kernels and name not in kernels:
            continue
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err, rel = cs._max_err(got, want)
        emit("case", kernel=name, shape=case_label, rel_err=rel,
             ev_ms=cs._time_ms(kern), dev_ms=cs._device_ms(kern), cold_dev_ms=_cold_ms(kern, flush),
             plain_ev_ms=cs._time_ms(plain), plain_dev_ms=cs._device_ms(plain),
             lib_ev_ms=None if lib is None else cs._time_ms(lib), lib_dev_ms=None if lib is None else cs._device_ms(lib),
             bound_ms=cs._bound(nbytes, flops)[0])
    if host:
        emit("host", segments_us=_host_segments(dev))
    if train:
        batches = cs._train_batches(dev, cs.TRAIN_STEPS)
        for arm, (loss_kw, _) in cs.ARMS.items():
            ms = {}
            for impl, route_name in ((None, "kernel"), ("plain", "plain")):
                step_ms = cs._train_route(dev, loss_kw, impl, batches)[2]
                ms[route_name] = statistics.median(step_ms[5:])
            emit("train", arm=arm, step_ms=ms)
    if lm:
        emit("lm", **_lm_window(cs, dev))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--out", default=None, help="also append the JSON lines here")
    ap.add_argument("--kernels", default="", help="comma list of kernels to time (default: all)")
    ap.add_argument("--no-train", action="store_true")
    ap.add_argument("--no-host", action="store_true")
    ap.add_argument("--no-lm", action="store_true")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--label", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    kernels = {k for k in args.kernels.split(",") if k}
    if args.one:
        return run_one(args.one, args.label, kernels, not args.no_train, not args.no_host, not args.no_lm)
    if not args.trees:
        ap.error("give at least one TREE")
    rc = 0
    for i, tree in enumerate(args.trees):
        label = f"{i}:{os.path.basename(os.path.abspath(tree))}"
        cmd = [sys.executable, os.path.abspath(__file__), "--one", tree, "--label", label, "--kernels", args.kernels]
        cmd += ["--no-train"] * args.no_train + ["--no-host"] * args.no_host + ["--no-lm"] * args.no_lm
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        for ln in lines:
            print(ln, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write("\n".join(lines) + "\n")
        if proc.returncode:
            print(f"kernel_ab: tree {tree} failed ({proc.returncode}):\n{proc.stderr[-4000:]}", file=sys.stderr)
            rc = proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
