"""Cost models that rank the port's configs (port of ``repro/tune/cost.py``).

Three tiers:

  * ``analytic_cost``    — closed-form FLOPs / HBM bytes / kernel launches
                           of a config.  Instant; the implicit dispatch
                           fallback.
  * ``compiled_cost``    — the "dry" tier: FLOPs and bytes of one call of
                           the candidate, analysed op by op on fake copies
                           of its inputs (``launch/hlo_cost.analyze``:
                           deterministic, nothing runs or is timed).
  * ``measured_time_us`` — best-of-N time of the candidate: CUDA events on a
                           card, ``perf_counter`` on the CPU.

Tile kernels and the page rank by an H100 roofline,
``max(flops / PEAK_FLOPS, hbm_bytes / HBM_BW) + launches * LAUNCH_OVERHEAD_S``
(flops and shared memory as tiebreaks), with the constants PERF.md's
bounds use; the per-launch term stands where the reference charges TPU grid
steps.  The plans rank flops-first, as in the reference: their padding
against factor balance (or DFT work against the pairwise stage) is
arithmetic, and the four-step cost is the reference's formula, so the port
picks the reference's plan for every d.  The grouped plan is charged the
port's own padding (the kernels' 4-float chunks), not the TPU's 128 lanes,
so its pick may differ from the reference's.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels.utils import next_multiple
from repro_torch.tune.space import Config, Shape, smem_bytes

F32 = 4
# H100 SXM data sheet: non-tensor-core f32 and HBM3 (PERF.md's bounds)
PEAK_FLOPS = 67e12
HBM_BW = 3.35e12
# host cost of one counted launch: the low end of the port's measured
# 24-43 us a launch chain on the H100 (PERF.md)
LAUNCH_OVERHEAD_S = 24e-6
# batch the plan cost amortizes batch-independent stages over (the paper's
# SSL batch); plans are chosen per d, so one representative n is used
NOMINAL_BATCH = 256
# the kernels' column chunk: narrower rows are zero-filled to it
_CHUNK = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sumvec_fft_plan_cost(d: int, cfg: Config) -> Dict[str, float]:
    """Closed-form {flops, hbm_bytes} of a four-step plan at NOMINAL_BATCH
    rows (the reference's formula)."""
    dp, d1, d2 = cfg["dp"], cfg["d1"], cfg["d2"]
    padded = dp > d
    # forward per batch row (both views: two cmatmul stages + one twiddle);
    # the inverse runs once on the batch-reduced accumulator
    fwd = 16.0 * dp * (d1 + d2) + 12.0 * dp
    inv = 8.0 * dp * (d1 + d2) + 6.0 * dp
    flops = NOMINAL_BATCH * fwd + (inv if padded else 0.0)
    hbm = F32 * (6.0 * dp * NOMINAL_BATCH + 2.0 * (d1 * d1 + d2 * d2))
    return {"flops": float(flops), "hbm_bytes": float(hbm)}


def analytic_cost(kernel: str, shape: Shape, cfg: Config) -> Dict[str, float]:
    """Closed-form {flops, hbm_bytes, launches, smem_bytes} of a config."""
    launches = 1.0
    if kernel == "xcorr_offdiag":
        n, d = shape
        tiles = _cdiv(d, cfg["bm"]) * _cdiv(d, cfg["bn"])
        flops = 2.0 * n * d * d
        hbm = F32 * (2.0 * n * d + 2.0 * tiles + 1.0)
        launches = 2.0  # the tile pass and the partials sum
    elif kernel == "cmatmul":
        m, k, n = shape
        flops = 8.0 * m * k * n
        hbm = F32 * 2.0 * (m * k + k * n + m * n)
    elif kernel == "pmatmul":
        m, k, n = shape
        flops = 2.0 * m * k * n
        hbm = F32 * (m * k + k * n + m * n)
    elif kernel == "ctwiddle":
        n, d = shape
        flops = 6.0 * n * d
        hbm = F32 * (4.0 * n * d + 2.0 * d)
    elif kernel == "freq_outer":
        f, k, n = shape
        flops = 2.0 * f * k * n * n
        hbm = F32 * f * (2.0 * k * n + n * n)
    elif kernel == "freq_mat":
        f, k, n, n2 = shape
        flops = 2.0 * f * k * n * n2
        hbm = F32 * f * (k * n + n * n2 + k * n2)
    elif kernel == "paged_attention":
        b, s, kv, hd = shape
        page = cfg["page"]
        nb = _cdiv(s, page)
        rows = nb * page  # the last page's dead rows are read too
        flops = 4.0 * b * rows * kv * hd  # q.k and p.v a context row
        hbm = F32 * (2.0 * b * rows * kv * hd + 2.0 * b * kv * hd) + 4.0 * b * nb  # + the block tables
    elif kernel == "grouped_block_plan":
        n, d = shape
        b = cfg["b"]
        nb = _cdiv(d, b)
        nf = b // 2 + 1
        cols = next_multiple(2 * nf, _CHUNK)
        nbp = next_multiple(nb, _CHUNK)
        # block DFT of both views: (n * nb, b) @ (b, 2 nf), columns chunked
        flops = 2.0 * 2.0 * (n * nb) * b * cols
        hbm = F32 * 2.0 * (n * nb * b + b * cols + n * nb * cols)
        # the pairwise stage, two freq_outers over (nf, 2n, nb), chunked
        flops += 2.0 * 2.0 * nf * (2.0 * n) * nbp * nbp
        hbm += F32 * 2.0 * nf * (2.0 * 2.0 * n * nbp + nbp * nbp)
        launches = 4.0
    elif kernel == "sumvec_fft_plan":
        (d,) = shape
        out = sumvec_fft_plan_cost(d, cfg)
        flops, hbm = out["flops"], out["hbm_bytes"]
        launches = 3.0 + (3.0 if cfg["dp"] > d else 0.0)
    else:
        raise KeyError(kernel)
    return {
        "flops": float(flops),
        "hbm_bytes": float(hbm),
        "launches": float(launches),
        "smem_bytes": float(smem_bytes(kernel, shape, cfg)),
    }


def rank_key(cost: Dict[str, float], kernel: str = "") -> Tuple[float, float, float]:
    """Smaller is better: flops-first for plans, else the H100 roofline."""
    if kernel in ("sumvec_fft_plan", "grouped_block_plan"):
        return (cost["flops"], cost["hbm_bytes"], cost.get("smem_bytes", 0.0))
    roofline_s = (
        max(cost["flops"] / PEAK_FLOPS, cost["hbm_bytes"] / HBM_BW)
        + cost.get("launches", 0.0) * LAUNCH_OVERHEAD_S
    )
    return (roofline_s, cost["flops"], cost.get("smem_bytes", 0.0))


# ---------------------------------------------------------------------------
# The dry and measured tiers
# ---------------------------------------------------------------------------


def compiled_cost(fn: Callable, *args) -> Dict[str, float]:
    """{flops, hbm_bytes} of one call of ``fn(*args)`` by the op-level
    analyzer (the reference's trip-exact ``compiled_cost``): the kernel
    route for CUDA operands (each launch at its C entry's formula), the
    plain route for CPU ones.  Nothing is allocated or run on a device."""
    # imported here, not at module top: the analytic tier (what the kernels
    # use implicitly) must not drag repro_torch.launch into the dispatch path
    from repro_torch.launch.hlo_cost import analyze

    a = analyze(fn, *args)
    return {"flops": a.flops, "hbm_bytes": a.hbm_bytes}


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def measured_time_us(fn: Callable, *args, repeats: int = 3, warmup: int = 1) -> float:
    """Best-of-``repeats`` time of ``fn(*args)`` in microseconds, after
    ``warmup`` untimed calls.  On a CUDA device (the tensors' among
    ``args``) each call is timed by CUDA events and synchronized before the
    clock is read; on the CPU by ``time.perf_counter``."""
    dev = _device_of(args)
    cuda = dev.type == "cuda"
    for _ in range(warmup):
        fn(*args)
    if cuda:
        torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(max(repeats, 1)):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, (time.perf_counter() - t0) * 1e6)
    return best
