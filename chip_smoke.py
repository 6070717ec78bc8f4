#!/usr/bin/env python3
"""GPU smoke of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check exits non-zero and prints no result):

  0. build — compiles every CUDA source of ``repro_torch/kernels/csrc`` into
     ``build/kernels/`` (one ``nvcc`` per source, all started together).
  1. kernels vs plain — each hand-written kernel (cmatmul, ctwiddle,
     pmatmul, freq_outer, freq_mat, xcorr_offdiag, paged_attention) runs at
     the shapes the
     serving and training paths give it (d = 2048 and 8192, b = 128,
     n = 256; the prime d = 2039 for the padded plan's q = 1 inverse path
     and the ragged R_off tiles; the LM probe's d = 2304), forward and,
     labelled ``bwd``, as the vjps call it, and at edge shapes that take the
     kernels' other paths (R_off: one tile, ragged last tiles, batches of 1,
     17 and 300, an operand 4 bytes off; paged attention: lengths around a
     split's CHUNK rows, a length of 1 in a wide table, a window that starts
     mid-chunk or exceeds every length, n_rep 1 to 8, hd 48 to 256, pages of
     5 and 16), and is held against its plain PyTorch version on the same
     inputs.  Prints max error, kernel / plain / library time and
     the bound; a cmatmul line names its library yardstick: complex ``@``,
     or, for the real-input stage and the vjp's Re-only output, the one real
     ``matmul`` that computes the same function.
     Then the gradient of the regularizer at the paper's width (n = 256,
     d = 8192; b = 128 and ungrouped, q = 2) on the kernel route against the
     ``impl="plain"`` route (``[grad]`` lines).  paged_attention also runs
     "hot" cases with q x 40 at softcap 30 / 50, where the cap moves the
     output by over 100 x the tolerance (a printed, checked control).
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
     device work by kernel name.  A ported kernel's device ms sums every
     ``__global__`` function of its source (``DEVICE_KERNELS``: R_off's tile
     pass and partials sum, paged attention's decode pass and split
     combine); a kernel whose launch counter moved in a profiled window but
     that shows no device time fails the phase (here, in 4 and in 5).
  4. train — ``make_ssl_train_step`` with LARS at the full ``ssl-paper``
     width (batch 256, ``ssl_batch`` data, random weights from a seed), 20
     steps of three arms on the kernel route and on the ``impl="plain"``
     route from the same parameters, batches and permutations:
     (a) BT, R_sum, b = 128, q = 2 (pmatmul, freq_outer, freq_mat);
     (b) VICReg, R_sum ungrouped, q = 1 (cmatmul, ctwiddle, forward and
     inverse four-step); (c) BT, R_off through the fused kernel
     (xcorr_offdiag).  Step-0 gradients per parameter and every step's loss
     must agree within 5e-4 relative, and every kernel of an arm must have
     launched on the forward and (but xcorr_offdiag, whose backward is torch
     products) the backward pass.  Prints median step ms per arm and route,
     then a profiler pass over 10 warmed steps of each arm (its kernels'
     device ms must be > 0).
  5. lm — paged continuous-batching LM serving of ``gemma2-2b`` at its full
     published width and depth (26 layers, d = 2304, 8 query / 4 kv heads of
     256, vocab 256000; random weights from ``init_params(seed=0)``) through
     ``ContinuousLMEngine(paged=True)`` under ``LMService`` with the
     in-flight decorrelation probe: (1) f32, 8 slots, page 16, the
     reference's ``LMLoadConfig()`` (24 requests): (a) paged tokens on the
     plain (gather) route equal the dense engine's bit for bit; (b) on the
     kernel route every decode tick is re-run on the plain route from a
     clone of the pool, logits within 1e-4 x max(1, max |logit|); (c) kernel
     route tokens equal the plain route's, a request's first difference
     allowed only at a step whose plain top-2 logit gap is below twice the
     measured logit difference; ``paged_attention`` launches 26 per decode
     tick, and the probe's cmatmul and ctwiddle launch (counts of this run
     alone); probe vs its oracle < 1e-3; no dispatch error.  (2) the same
     checks on 2 requests of 4160 prompt tokens + 16 new (f32, max_len
     4224), decoding past the 4096 window of the local layers.  (3) the
     config's own bf16, workload (1), timed: tok/s, TTFT, decode tick and
     prefill ms, a profiled window of 10 ticks (idle share, largest device
     items), kernel-vs-plain logit difference (reported, not gated).
  6. report — one JSON ``kernels`` line, the card's name and power limit,
     and the last line ``{"ok": true, "device": {...}}``.

Times are CUDA-event means over repeated launches with inputs resident in
L2 where they fit (the service finds them warm: each stage reads what the
previous one just wrote); they include the host's launch cost when the
host, not the device, is the slower side.  "device-only" times sum the
durations of the device work per call from a profiler (CUPTI) trace.  ``bound_ms`` is the larger of bytes / 3.35 TB/s
and f32 operations / 67 TFLOP/s (H100 SXM data sheet, non-tensor-core f32),
counting each input read once and each output written once (paged
attention: the live rows only — min(len, window) per slot).
"""

from __future__ import annotations

import json
import math
import os
import re
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
# train phase and [grad] lines: losses and gradients, kernel route vs plain
# route, the reference's loss tolerance (5e-4 relative; a gradient relative
# to its own largest magnitude)
LOSS_TOL = 5e-4
N_REQUESTS = 512
SEED = 0
TRAIN_STEPS = 20
PROFILE_STEPS = 10
# peak learning rate of the checked runs (LARS, warmup 2 steps, cosine).  At
# the training CLI's 0.2 the trajectory at this width is chaotic on the card: the
# plain route against itself with every parameter scaled by (1 + 1e-7 noise)
# drifts apart by ~1e-3 in 20 steps, so no two routes that differ at f32
# rounding can agree to 5e-4 there.  The [train] sensitivity line measures
# this each run; the checked runs use a peak lr at which the trajectory
# holds the routes' rounding differences.
TRAIN_LR = 0.05
SENSITIVITY_LR = 0.2
# lm phase: kernel-route logits vs the plain route's on the same pool state,
# relative to max(1, max |logit|) — the reference's 1e-4 logit tolerance
LOGIT_TOL = 1e-4
# lm phase: probe on the served hidden rows vs its offline oracle (the
# reference CLI's gate)
LM_PROBE_TOL = 1e-3
LM_SLOTS = 8
LM_PAGE = 16
# the kernels of the LM path's probe: ungrouped R_sum of the hidden rows at
# d = 2304 through the four-step DFT
LM_PROBE_KERNELS = ("cmatmul", "ctwiddle")
LONG_PROMPT, LONG_NEW, LONG_MAX_LEN = 4160, 16, 4224
LM_PROFILE_TICKS = 10

REPLACES = {
    "cmatmul": "src/repro/kernels/sumvec_fft/kernel.py:54",
    "ctwiddle": "src/repro/kernels/sumvec_fft/kernel.py:131",
    "pmatmul": "src/repro/kernels/grouped_sumvec/kernel.py:49",
    "freq_outer": "src/repro/kernels/grouped_sumvec/kernel.py:115",
    "freq_mat": "src/repro/kernels/grouped_sumvec/kernel.py:153",
    "xcorr_offdiag": "src/repro/kernels/xcorr_offdiag/kernel.py:53",
    "paged_attention": "src/repro/kernels/paged_attention/kernel.py:102",
}
SOURCES = {
    "cmatmul": "src/repro_torch/kernels/csrc/sumvec_fft.cu",
    "ctwiddle": "src/repro_torch/kernels/csrc/sumvec_fft.cu",
    "pmatmul": "src/repro_torch/kernels/csrc/grouped_sumvec.cu",
    "freq_outer": "src/repro_torch/kernels/csrc/grouped_sumvec.cu",
    "freq_mat": "src/repro_torch/kernels/csrc/grouped_sumvec.cu",
    "xcorr_offdiag": "src/repro_torch/kernels/csrc/xcorr_offdiag.cu",
    "paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
}
# every __global__ function of each kernel's source, by the kernel whose
# wrapper launches it: the profiler's device time of a kernel is the sum over
# these names (xcorr_offdiag's tile pass and its partials sum, paged
# attention's decode pass and its split combine)
DEVICE_KERNELS = {
    "cmatmul": ("cmatmul_kernel",),
    "ctwiddle": ("ctwiddle_kernel",),
    "pmatmul": ("pmatmul_kernel",),
    "freq_outer": ("freq_outer_kernel",),
    "freq_mat": ("freq_mat_kernel",),
    "xcorr_offdiag": ("xcorr_tile_kernel", "sum_partials_kernel"),
    "paged_attention": ("paged_decode_kernel", "paged_combine_kernel"),
}
# the training arms: (DecorrConfig keywords, the kernels the arm runs)
ARMS = {
    "a bt r_sum b=128 q=2": (dict(style="bt", reg="sum", block_size=128, q=2), ("pmatmul", "freq_outer", "freq_mat")),
    "b vic r_sum ungrouped q=1": (dict(style="vic", reg="sum", block_size=None, q=1), ("cmatmul", "ctwiddle")),
    "c bt r_off fused": (dict(style="bt", reg="off", use_kernel=True), ("xcorr_offdiag",)),
}
# kernels whose backward pass is a kernel too (xcorr_offdiag's is torch products)
WITH_KERNEL_BWD = ("cmatmul", "ctwiddle", "pmatmul", "freq_outer", "freq_mat")


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


_OWNER = {sym: kernel for kernel, symbols in DEVICE_KERNELS.items() for sym in symbols}
_SYMBOL = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(_OWNER) + r")(?![A-Za-z0-9_])")


def kernel_of(device_name: str):
    """The ported kernel a profiler device event belongs to (by the
    ``DEVICE_KERNELS`` names, matched as whole identifiers), or None."""
    found = _SYMBOL.search(device_name)
    return _OWNER[found.group(1)] if found else None


def _ported_ms(ph, events, counts, names, where):
    """{kernel: (device ms, device launches)} of ``names`` in a profiled
    window's events; a kernel whose launch counter moved in the window but
    that shows no device time fails the phase."""
    ours = {k: [0.0, 0] for k in names}
    for name, us in events:
        k = kernel_of(name)
        if k in ours:
            ours[k][0] += us / 1e3
            ours[k][1] += 1
    for k in names:
        ph.check(counts.get(k, 0) == 0 or ours[k][0] > 0,
                 f"[profile] {where}: {k} launched {counts.get(k, 0)} times but shows no device time")
    return ours


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
    from repro_torch.kernels.utils import dft_matrices, full_dft_adjoint, full_dft_matrices
    from repro_torch.kernels.xcorr_offdiag import kernel as xk

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    rand = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
    n, b = 256, 128
    cases = []

    def cmm(label, m, k, nn, real_a, sign=-1, offset=0, basis=None):
        # B: the DFT basis of the plan (k == nn), or a random (k, nn) one
        br, bi = full_dft_matrices(k, sign, dev) if basis is None else (rand(k, nn), rand(k, nn))
        ar = view(offset, m, k)
        ai = None if real_a else rand(m, k)
        if real_a:  # one real product computes the same function: Ar @ [Br | Bi]
            bcat = torch.cat([br, bi], 1)
            lib, yard = (lambda: ar @ bcat), "real ar @ [br|bi]"
        else:
            ac, bc = torch.complex(ar, ai), torch.complex(br, bi)
            lib, yard = (lambda: ac @ bc), "complex @"
        nbytes = 4 * (m * k * (1 if real_a else 2) + 2 * k * nn + 2 * m * nn)
        flops = (4 if real_a else 8) * m * k * nn
        cases.append((
            "cmatmul", f"{label} [library: {yard}]",
            lambda: fk.cmatmul(ar, ai, br, bi),
            lambda: fk.cmatmul_plain(ar, ai, br, bi),
            lib, nbytes, flops,
        ))

    def view(offset, *shape):  # contiguous, ``offset`` floats into its buffer
        return rand(offset + math.prod(shape))[offset:].view(*shape)

    def ctw(label, rows, d, offset=0):
        xr, xi, wr, wi = view(offset, rows, d), rand(rows, d), rand(d), rand(d)
        xc, wc = torch.complex(xr, xi), torch.complex(wr, wi)
        cases.append((
            "ctwiddle", label,
            lambda: fk.ctwiddle(xr, xi, wr, wi),
            lambda: fk.ctwiddle_plain(xr, xi, wr, wi),
            lambda: xc * wc,
            4 * (4 * rows * d + 2 * d), 6 * rows * d,
        ))

    def pmm(label, m, k, nn, basis=None, offset=0):
        a = view(offset, m, k)
        bmat = rand(k, nn) if basis is None else basis
        cases.append((
            "pmatmul", label,
            lambda: gk.pmatmul(a, bmat),
            lambda: gk.pmatmul_plain(a, bmat),
            lambda: torch.matmul(a, bmat),
            4 * (m * k + k * nn + m * nn), 2 * m * k * nn,
        ))

    def cmm_bwd(label, m, k, nn, real_out):
        # the vjp's dA = g @ B^H at the forward's shape; the real-input first
        # stage asks for Re dA only, which one real product computes:
        # [Gr | Gi] @ [BHr ; -BHi]
        bhr, bhi = full_dft_adjoint(k, -1, dev)
        gr, gi = rand(m, nn), rand(m, nn)
        if real_out:
            gcat, bcat = torch.cat([gr, gi], 1), torch.cat([bhr, -bhi], 0)
            lib, yard = (lambda: gcat @ bcat), "real [gr|gi] @ [bhr;-bhi]"
        else:
            gc, bhc = torch.complex(gr, gi), torch.complex(bhr, bhi)
            lib, yard = (lambda: gc @ bhc), "complex @"
        pick = (lambda c: c[0]) if real_out else (lambda c: c)
        nbytes = 4 * (2 * m * nn + 2 * nn * k + (1 if real_out else 2) * m * k)
        flops = (4 if real_out else 8) * m * nn * k
        cases.append((
            "cmatmul", f"{label} [library: {yard}]",
            lambda: pick(fk._cmatmul_launch(gr, gi, bhr, bhi, real_out=real_out)),
            lambda: pick(fk.cmatmul_plain(gr, gi, bhr, bhi)),
            lib, nbytes, flops,
        ))

    def fm(label, f, k, nn, n2, offset=0):
        a, m = view(offset, f, k, nn), rand(f, nn, n2)
        cases.append((
            "freq_mat", label,
            lambda: gk.freq_mat(a, m),
            lambda: gk.freq_mat_plain(a, m),
            lambda: torch.bmm(a, m),
            4 * (f * k * nn + f * nn * n2 + f * k * n2), 2 * f * k * nn * n2,
        ))

    def xc(label, rows, d, offset=0):
        z1, z2 = view(offset, rows, d), rand(rows, d)

        def library():  # cuBLAS C = z1^T z2 (TF32 off), then the square-sum
            c = z1.T @ z2
            return torch.sum(c * c) - torch.sum(torch.diagonal(c) ** 2)

        cases.append((
            "xcorr_offdiag", label,
            lambda: xk.off_diagonal_sq_sum_raw(z1, z2),
            lambda: xk.off_diagonal_sq_sum_plain(z1, z2),
            library,
            4 * (2 * rows * d + 1), 2 * rows * d * d + 2 * d * d,
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
    block_basis_t = block_basis.T.contiguous()
    for d in (2048, 8192):
        p = fft_plan(d)
        cmm(f"d={d} stage1 ({n * p.d2},{p.d1})x({p.d1},{p.d1}) real A", n * p.d2, p.d1, p.d1, True)
        ctw(f"d={d} twiddle ({n},{d})", n, d)
        cmm(f"d={d} stage3 ({n * p.d1},{p.d2})x({p.d2},{p.d2})", n * p.d1, p.d2, p.d2, False)
        nb = d // b
        pmm(f"d={d} block DFT ({n * nb},{b})x({b},{2 * nf})", n * nb, b, 2 * nf, block_basis)
        fo(f"d={d} freq_outer ({nf},{2 * n},{nb})", nf, 2 * n, nb)
        pmm(f"d={d} q=1 synthesis ({nb * nb},{nf})x({nf},{b})", nb * nb, nf, b)
        fm(f"d={d} freq_mat ({nf},{2 * n},{nb})x({nf},{nb},{nb})", nf, 2 * n, nb, nb)
        xc(f"d={d} xcorr ({n},{d})", n, d)
        cmm_bwd(f"bwd d={d} stage1 dA ({n * p.d2},{p.d1})x({p.d1},{p.d1}) real out", n * p.d2, p.d1, p.d1, True)
        cmm_bwd(f"bwd d={d} stage3 dA ({n * p.d1},{p.d2})x({p.d2},{p.d2})", n * p.d1, p.d2, p.d2, False)
        pmm(f"bwd d={d} block DFT dA ({n * nb},{2 * nf})x({2 * nf},{b})", n * nb, 2 * nf, b, block_basis_t)
    # the other paths of the redesigned kernels: ctwiddle with d % 4 != 0 (the
    # padded plan of d = 61), an operand at an odd offset, rows not a multiple
    # of the 4 a thread owns; pmatmul with N = 65 and N = 300 (past a block's
    # 132 columns), the vjp's dB (K = 4096, many ring stages), M = 1, A at an
    # odd offset, K = 130 (A resident, as in the bwd dA above) at an odd
    # offset, K = 257 (too deep to stay resident, a 1-deep last slice)
    ctw(f"edge dp=121 twiddle ({n},121)", n, 121)
    ctw("edge xr at +4 bytes twiddle (256,2048)", n, 2048, offset=1)
    ctw("edge rows=257 twiddle (257,2048)", 257, 2048)
    pmm("edge N=65 (300,128)x(128,65)", 300, 128, 65)
    pmm(f"edge bwd dB ({b},4096)x(4096,{2 * nf})", b, 4096, 2 * nf)
    pmm(f"edge M=1 (1,{b})x({b},{2 * nf})", 1, b, 2 * nf, block_basis)
    pmm(f"edge A at +4 bytes ({16 * n},{b})x({b},{2 * nf})", 16 * n, b, 2 * nf, block_basis, offset=1)
    pmm(f"edge K=130 A at +4 bytes (300,{2 * nf})x({2 * nf},{b})", 300, 2 * nf, b, block_basis_t, offset=1)
    pmm(f"edge K=257 (77,257)x(257,{2 * nf})", 77, 257, 2 * nf)
    pmm("edge N=300 (70,40)x(40,300)", 70, 40, 300)
    # the other paths of the redesigned cmatmul and freq_mat: N = 11 (the
    # dp = 121 plan of d = 61, scalar twin), M = 1, M no multiple of a strip's
    # rows, A 4 bytes off a 16-byte boundary (no bulk copy), K too deep for B
    # to stay resident (a ring of K slices); freq_mat with N = N2 = 9 and a at
    # an odd offset (scalar twin), K no multiple of a block's rows
    cmm("edge dp=121 stage1 (2816,11)x(11,11) real A", 2816, 11, 11, True)
    cmm("edge dp=121 stage3 (2816,11)x(11,11)", 2816, 11, 11, False)
    cmm("edge M=1 (1,64)x(64,64)", 1, 64, 64, False)
    cmm("edge M=8191 (8191,64)x(64,64)", 8191, 64, 64, False)
    cmm("edge A at +4 bytes (8192,64)x(64,64)", 8192, 64, 64, False, offset=1)
    cmm("edge K=600 (64,600)x(600,40)", 64, 600, 40, False, basis="random")
    cmm_bwd("edge bwd M=8191 real out (8191,64)x(64,64)", 8191, 64, 64, True)
    fm(f"edge N=N2=9 freq_mat ({nf},{2 * n},9)x({nf},9,9)", nf, 2 * n, 9, 9)
    fm(f"edge a at +4 bytes freq_mat ({nf},{2 * n},16)x({nf},16,16)", nf, 2 * n, 16, 16, offset=1)
    fm(f"edge K=500 freq_mat ({nf},500,16)x({nf},16,16)", nf, 500, 16, 16)
    # the LM path's probe: ungrouped R_sum of 8-row windows at d = 2304
    p = fft_plan(2304)
    cmm(f"lm d=2304 stage1 ({8 * p.d2},{p.d1})x({p.d1},{p.d1}) real A", 8 * p.d2, p.d1, p.d1, True)
    cmm(f"lm d=2304 stage3 ({8 * p.d1},{p.d2})x({p.d2},{p.d2})", 8 * p.d1, p.d2, p.d2, False)
    p = fft_plan(2039)  # prime: padded plan, q = 1 needs the inverse pipeline
    cmm(f"d=2039 dp={p.dp} stage1 ({n * p.d2},{p.d1})x({p.d1},{p.d1}) real A", n * p.d2, p.d1, p.d1, True)
    ctw(f"d=2039 dp={p.dp} twiddle ({n},{p.dp})", n, p.dp)
    cmm(f"d=2039 dp={p.dp} stage3 ({n * p.d1},{p.d2})x({p.d2},{p.d2})", n * p.d1, p.d2, p.d2, False)
    cmm(f"d=2039 inverse ({p.d1},{p.d2})x({p.d2},{p.d2})", p.d1, p.d2, p.d2, False, sign=1)
    ctw(f"d=2039 inverse twiddle (1,{p.dp})", 1, p.dp)
    cmm(f"d=2039 inverse ({p.d2},{p.d1})x({p.d1},{p.d1})", p.d2, p.d1, p.d1, False, sign=1)
    xc(f"d=2039 xcorr ({n},2039) ragged tiles", n, 2039)
    # the redesigned xcorr_offdiag's other paths: one tile, a ragged last
    # tile column of 1 or 2 (d % 4 != 0: the scalar twin), a batch of 1, a
    # batch that is no multiple of a ring stage's rows, z1 4 bytes off a
    # 16-byte boundary (the scalar twin at d = 2048)
    xc("edge d=128 xcorr (256,128)", n, 128)
    xc("edge d=129 n=17 xcorr (17,129)", 17, 129)
    xc("edge d=130 n=300 xcorr (300,130)", 300, 130)
    xc("edge n=1 xcorr (1,2039)", 1, 2039)
    xc("edge n=17 xcorr (17,8192)", 17, 8192)
    xc("edge n=300 xcorr (300,2048)", 300, 2048)
    xc("edge z1 at +4 bytes xcorr (256,2048)", n, 2048, offset=1)
    _paged_cases(cases, dev, gen)
    return cases


# paged_attention's phase-1 shape: gemma2-2b's heads (8 query / 4 kv of
# 256) and scale (query_pre_attn_scalar = 256), the LM path's page
PAGED_SHAPE = dict(h=8, kv=4, hd=256, page=LM_PAGE, scale=1.0 / 16.0)
# q gain that lifts |scale * q.k| to ~30-150, where the softcap 50 * tanh(s/50)
# moves the output far more than the tolerance (unit q keeps |s| near 3)
HOT_Q = 40.0


def _paged_inputs(dev, gen, lens, dtype, q_gain=1.0, shape=PAGED_SHAPE, nb=0):
    """q (B, H, hd) f32, k/v page pools in ``dtype``, a permuted block table
    with a ragged page count per slot (unused entries on the sentinel page
    0; at least ``nb`` entries wide) and int32 lengths, all on ``dev``."""
    import torch

    h, kv, hd, page = (shape[k] for k in ("h", "kv", "hd", "page"))
    b = len(lens)
    need = [-(-n // page) for n in lens]
    nb = max(max(need), nb)
    p_total = sum(need) + 1
    ids = (torch.randperm(p_total - 1, generator=gen) + 1).tolist()
    table = torch.zeros((b, nb), dtype=torch.int32)
    for i, k in enumerate(need):
        table[i, :k] = torch.tensor(ids[:k], dtype=torch.int32)
        ids = ids[k:]
    q = (torch.randn(b, h, hd, generator=gen) * q_gain).to(dev)
    kp = torch.randn(p_total, page, kv, hd, generator=gen).to(dtype).to(dev)
    vp = torch.randn(p_total, page, kv, hd, generator=gen).to(dtype).to(dev)
    return q, kp, vp, table.to(dev), torch.tensor(lens, dtype=torch.int32, device=dev)


def _paged_cases(cases, dev, gen):
    """paged_attention at the LM path's decode shape (8 slots, 8 query / 4
    kv heads of 256, page 16, lengths as the 24-request workload leaves
    them) and at a long-context shape (lengths up to 8192): f32 and bf16
    pages, softcap 0 / 50, window 0 / 4096, a ragged page count per slot
    (permuted physical pages, unused entries on the sentinel) and a length
    of 1; and "hot" cases with q * HOT_Q at softcap 30 / 50, where the cap
    changes the output (``_softcap_control`` shows by how much).  The
    library yardstick is ``scaled_dot_product_attention`` on the
    pre-gathered, head-expanded dense view (gather excluded from its time),
    the one PyTorch call that computes the same function — at softcap 0 and
    window 0 only."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention.ops import paged_decode_plain
    from repro_torch.kernels.paged_attention.ref import gather_pages

    def case(label, lens, dtype, softcap, window, q_gain=1.0, shape=PAGED_SHAPE, nb=0):
        h, kv, hd, page, scale = (shape[k] for k in ("h", "kv", "hd", "page", "scale"))
        b = len(lens)
        nb = max(max(-(-n // page) for n in lens), nb)
        q, kp, vp, table, lens_t = _paged_inputs(dev, gen, lens, dtype, q_gain, shape, nb)
        kw = dict(scale=scale, softcap=softcap, window=window)
        lib = None
        if not softcap and not window:
            kd = gather_pages(kp, table).float().repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
            vd = gather_pages(vp, table).float().repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
            mask = (torch.arange(nb * page, device=dev)[None, :] < lens_t[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]
            lib = lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask, scale=scale)[:, :, 0]
        rows = sum(min(n, window) if window else n for n in lens)
        elt = torch.empty((), dtype=dtype).element_size()
        nbytes = rows * kv * hd * 2 * elt + 2 * 4 * b * h * hd + 4 * (b * nb + b)
        cases.append((
            "paged_attention", label,
            lambda: pk.paged_decode_attention(q, kp, vp, table, lens_t, **kw),
            lambda: paged_decode_plain(q, kp, vp, table, lens_t, **kw),
            lib, nbytes, 4 * rows * h * hd,
        ))

    main_lens = [1, 5, 17, 24, 33, 44, 16, 40]
    long_lens = [8192, 7001, 4097, 4096, 2500, 1000, 17, 1]
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        case(f"main {tag} softcap=50 window=4096 (B=8,H=8,KV=4,hd=256,page=16)", main_lens, dtype, 50.0, 4096)
        case(f"main {tag} softcap=50 window=0", main_lens, dtype, 50.0, 0)
        case(f"main {tag} softcap=0 window=0", main_lens, dtype, 0.0, 0)
    case("long bf16 softcap=50 window=4096 (B=8, lens to 8192)", long_lens, torch.bfloat16, 50.0, 4096)
    case("long bf16 softcap=50 window=0", long_lens, torch.bfloat16, 50.0, 0)
    case("long bf16 softcap=0 window=0", long_lens, torch.bfloat16, 0.0, 0)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for softcap in (30.0, 50.0):
            case(f"hot {tag} softcap={softcap:g} window=4096 q*{HOT_Q:g}", main_lens, dtype, softcap, 4096, HOT_Q)
    case(f"hot long bf16 softcap=50 window=4096 q*{HOT_Q:g}", long_lens, torch.bfloat16, 50.0, 4096, HOT_Q)
    # the split kernel's edges (CHUNK rows a block): lengths at CHUNK - 1,
    # CHUNK, CHUNK + 1 and past two chunks; a length of 1 in a 4096-row
    # table (15 of 16 chunks empty); a window whose start lo falls inside a
    # page and leaves a ragged last chunk; a window longer than every
    # length; n_rep 1, 4 and 8 with hd 128 and 48 and a page of 5
    ch = pk.CHUNK
    edge = [ch - 1, ch, ch + 1, 1, 2 * ch + 1, 3 * ch - 1, 3 * ch, 3 * ch + 1]
    case(f"edge lens at CHUNK-1/CHUNK/CHUNK+1 bf16 softcap=50 window=0 (lens {edge})", edge, torch.bfloat16, 50.0, 0)
    case("edge len=1 in a wide table f32 softcap=0 window=0 (NB=256)", [1, 1, 2, 1, 1, 3, 1, 1], torch.float32,
         0.0, 0, nb=256)
    case("edge window=700 lo mid-chunk bf16 softcap=50", [1000, 777, 300, 5000, 4097, 17, 2600, 1],
         torch.bfloat16, 50.0, 700)
    case("edge window=9000 > len bf16 softcap=30", long_lens, torch.bfloat16, 30.0, 9000)
    for h_, kv_, hd_, page_ in ((4, 4, 128, 5), (8, 2, 128, 16), (8, 1, 48, 5)):
        shape = dict(h=h_, kv=kv_, hd=hd_, page=page_, scale=hd_ ** -0.5)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            case(f"edge n_rep={h_ // kv_} hd={hd_} page={page_} {tag} softcap=50 window=300",
                 [300, 1, ch + 1, 40, 2 * ch, 999], dtype, 50.0, 300, shape=shape)
        case(f"edge n_rep={h_ // kv_} hd={hd_} page={page_} f32 softcap=0 window=0",
             [300, 1, ch + 1, 40, 2 * ch, 999], torch.float32, 0.0, 0, shape=shape)


def _softcap_control(ph: Phase, dev):
    """The hot cases' inputs do reach the softcap: their scores run to
    |s| >= 30, and the plain version's output at softcap 30 / 50 differs from
    the uncapped one by more than 100 x the kernel tolerance, so a kernel
    that dropped or mis-scaled the tanh cap fails those cases."""
    import torch

    from repro_torch.kernels.paged_attention.ops import paged_decode_plain
    from repro_torch.kernels.paged_attention.ref import gather_pages

    gen = torch.Generator().manual_seed(SEED + 7)
    q, kp, vp, table, lens_t = _paged_inputs(dev, gen, [1, 5, 17, 24, 33, 44, 16, 40], torch.float32, HOT_Q)
    kv, scale = PAGED_SHAPE["kv"], PAGED_SHAPE["scale"]
    kd = gather_pages(kp, table)  # (B, NB * page, KV, hd)
    s = torch.einsum("bgrd,btgd->bgrt", q.view(q.shape[0], kv, -1, q.shape[-1]), kd) * scale
    live = torch.arange(kd.shape[1], device=dev)[None, :] < lens_t[:, None]
    s_max = float(s.abs().masked_fill(~live[:, None, None, :], 0.0).max())
    uncapped = paged_decode_plain(q, kp, vp, table, lens_t, scale=scale)
    for softcap in (30.0, 50.0):
        capped = paged_decode_plain(q, kp, vp, table, lens_t, scale=scale, softcap=softcap)
        diff = float((capped - uncapped).abs().max())
        tol = KERNEL_TOL * max(1.0, float(capped.abs().max()))
        ph.check(s_max >= 30.0 and diff > 100 * tol,
                 f"paged_attention hot cases: softcap={softcap:g} moves the plain output by {diff:.3g} "
                 f"(needs > 100 x tol {tol:.3g}), max |s| {s_max:.1f} (needs >= 30)")
        print(f"[kernel] paged_attention softcap control: q*{HOT_Q:g} max|s|={s_max:.1f}; plain output at "
              f"softcap={softcap:g} vs uncapped max_abs_diff={diff:.4g} = {diff / tol:.0f} x the kernel tolerance",
              flush=True)


# the case whose numbers stand for each kernel in the JSON line: the main
# path's shape at the served width d = 2048
JSON_CASE = {
    "cmatmul": "d=2048 stage3",
    "ctwiddle": "d=2048 twiddle",
    "pmatmul": "d=2048 block DFT",
    "freq_outer": "d=2048 freq_outer",
    "freq_mat": "d=2048 freq_mat",
    "xcorr_offdiag": "d=2048 xcorr",
    "paged_attention": "main bf16 softcap=50 window=4096",
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
        l_ms = _time_ms(lib) if lib is not None else None
        b_ms, by = _bound(nbytes, flops)
        if lib is None:
            lib_txt, lib_dev = "library_ms=none (no single PyTorch call)", "none"
        else:
            lib_txt = f"library_ms={l_ms:.5f}" + (" (gather excluded)" if name == "paged_attention" else "")
            lib_dev = _fmt(_device_ms(lib))
        print(
            f"[kernel] {name:<10} {label}: max_abs_err={err:.3g} rel={rel:.3g} "
            f"kernel_ms={k_ms:.5f} plain_ms={p_ms:.5f} {lib_txt} "
            f"bound_ms={b_ms:.5f} ({by}) | device-only ms: kernel={_fmt(_device_ms(kern))} "
            f"plain={_fmt(_device_ms(plain))} library={lib_dev}",
            flush=True,
        )
        if label.startswith(JSON_CASE[name]):
            rows[name] = {
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "shape": label, "max_abs_err": err,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
                "library_ms": l_ms,
            }
    _softcap_control(ph, dev)
    _grad_checks(ph, dev)
    return rows


def _grad_checks(ph: Phase, dev):
    """The regularizer's gradient at the paper's width (n = 256, d = 8192),
    kernel route vs ``impl="plain"`` route, b = 128 and ungrouped, q = 2;
    with the time of one forward + backward on each route."""
    import torch

    from repro_torch.core import regularizers as regs

    gen = torch.Generator(device="cpu").manual_seed(SEED + 7)
    n, d = 256, 8192
    z1 = torch.randn(n, d, generator=gen).to(dev).requires_grad_()
    z2 = (0.6 * z1.detach() + 0.8 * torch.randn(n, d, generator=gen).to(dev)).requires_grad_()
    for block in (128, None):
        def fwd_bwd(impl):
            loss = regs.r_sum_auto(z1, z2, q=2, block_size=block, scale=n, impl=impl)
            return (loss,) + torch.autograd.grad(loss, (z1, z2))

        got, want = fwd_bwd(None), fwd_bwd("plain")
        torch.cuda.synchronize()
        loss_rel = abs(float(got[0].detach()) - float(want[0].detach())) / abs(float(want[0].detach()))
        grad_rel = max(_max_err(g, w)[0] / float(w.abs().max()) for g, w in zip(got[1:], want[1:]))
        tag = f"n={n} d={d} b={block} q=2"
        ph.check(loss_rel <= LOSS_TOL, f"[grad] {tag}: loss rel err {loss_rel:.3g}")
        ph.check(grad_rel <= LOSS_TOL, f"[grad] {tag}: grad rel err {grad_rel:.3g}")
        print(
            f"[grad] {tag}: loss_rel_err={loss_rel:.3g} grad_rel_err={grad_rel:.3g} "
            f"fwd_bwd_ms kernel={_time_ms(lambda: fwd_bwd(None), iters=10):.4f} "
            f"plain={_time_ms(lambda: fwd_bwd('plain'), iters=10):.4f}",
            flush=True,
        )


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


def _profile_once(ph: Phase, dev, block_size):
    """Serve 512 requests on a warmed service under the profiler: wall time
    vs summed device time, and the device work by kernel name."""
    import time as _time

    from repro_torch import kernels
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

    kernels.reset_launch_counts()
    try:
        events = _device_events(serve)
    finally:
        service.stop()
    counts = kernels.launch_counts()
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    tops = "; ".join(f"{n[:60]}={us / 1e3:.4f}ms" for n, us in top)
    ours = _ported_ms(ph, events, counts, REPLACES, f"probe block={block_size}")
    wall_ms = wall[0] * 1e3
    print(
        f"[profile] probe block={block_size}: {N_REQUESTS} requests wall_ms={wall_ms:.3f} "
        f"device_busy_ms={busy_ms:.4f} idle_share={1 - busy_ms / wall_ms:.4f} "
        f"device events={len(events)} | ported kernels ms: "
        + " ".join(f"{k}={ms:.4f}" for k, (ms, _) in ours.items())
        + f" | top: {tops}",
        flush=True,
    )


def phase_profile(ph: Phase, dev):
    for block in (None, 128):
        _profile_once(ph, dev, block)


def phase_service(ph: Phase, dev):
    totals = {}
    for block, expect in ((None, ("cmatmul", "ctwiddle")), (128, ("pmatmul", "freq_outer"))):
        counts = _serve_once(ph, dev, block, expect)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    return totals


# ---------------------------------------------------------------------------
# phase 4: SSL training at the ssl-paper width, kernel route vs plain route
# ---------------------------------------------------------------------------


def _grad_rel(got, want) -> float:
    """Worst per-parameter gradient error, each relative to that parameter's
    largest gradient — or to 1e-3 of the largest over all parameters where a
    gradient vanishes in exact arithmetic (the projector's last bias: the
    losses standardize or center it away), so rounding noise is not read as
    a relative error of 1."""
    scales = [float(w.abs().max()) for w in want]
    floor = 1e-3 * max(scales)
    return max(_max_err(g, w)[0] / max(sc, floor) for g, w, sc in zip(got, want, scales))


def _train_setup(dev, loss_kw, impl, lr=TRAIN_LR, perturb=0.0):
    """(state, train_step, loss_fn) from the seeded ssl-paper model;
    ``perturb`` scales every parameter by (1 + perturb * seeded noise)."""
    import torch

    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.optim import lars, warmup_cosine
    from repro_torch.train import create_train_state, init_ssl_model, make_ssl_train_step

    model_cfg, _ = _paper()
    opt = lars(weight_decay=1e-4)
    model = init_ssl_model(model_cfg, seed=SEED, device=dev)
    if perturb:
        gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=gen).to(dev))
    state = create_train_state(model, opt, seed=SEED)
    sched = warmup_cosine(lr, 2, TRAIN_STEPS)
    step, loss_fn = make_ssl_train_step(model_cfg, DecorrConfig(**loss_kw), opt, sched, impl=impl)
    return state, step, loss_fn


def _max_rel(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def _train_route(dev, loss_kw, impl, batches, **setup_kw):
    """Step-0 gradients, then TRAIN_STEPS steps: (grads, losses, step ms,
    fwd launches, bwd launches, final state, step fn).  Launch counters are
    cleared just after the gradient comparison and read after the steps."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.permutation import permutation_for_step

    state, step, loss_fn = _train_setup(dev, loss_kw, impl, **setup_kw)
    perm = permutation_for_step(state.seed, 0, state.model.d).to(dev)
    params = list(state.model.parameters())
    grads = torch.autograd.grad(loss_fn(state.model, batches[0], perm)[0], params)
    torch.cuda.synchronize()
    key = f"{loss_kw['style']}_loss"
    losses, step_ms = [], []
    kernels.reset_launch_counts()
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics[key])
    fwd, bwd = kernels.launch_counts(), kernels.backward_launch_counts()
    return grads, torch.stack(losses).cpu().tolist(), step_ms, fwd, bwd, state, step


def _train_batches(dev, n):
    import torch

    from repro_torch.configs import ssl_paper
    from repro_torch.data import SSLDataConfig, ssl_batch

    paper = ssl_paper.config()
    data = SSLDataConfig(input_dim=paper.input_dim, batch=paper.batch_size, seed=SEED)
    out = []
    for s in range(n):
        v1, v2 = ssl_batch(data, s)
        out.append({"view1": torch.from_numpy(v1).to(dev), "view2": torch.from_numpy(v2).to(dev)})
    return out


def phase_train(ph: Phase, dev):
    """The three arms, kernel route (the main path) and plain route; returns
    ({kernel: forward launches}, {kernel: backward launches}) summed over the
    arms' kernel-route runs."""
    import statistics

    batches = _train_batches(dev, TRAIN_STEPS)
    fwd_total, bwd_total = {}, {}
    profiled = []
    for arm, (loss_kw, names) in ARMS.items():
        k_grads, k_loss, k_ms, fwd, bwd, k_state, k_step = _train_route(dev, loss_kw, None, batches)
        p_grads, p_loss, p_ms, _, _, _, _ = _train_route(dev, loss_kw, "plain", batches)
        grad_rel = _grad_rel(k_grads, p_grads)
        loss_rel = _max_rel(k_loss, p_loss)
        ph.check(grad_rel <= LOSS_TOL, f"[train] {arm}: step-0 grad rel err {grad_rel:.3g} > {LOSS_TOL}")
        ph.check(loss_rel <= LOSS_TOL, f"[train] {arm}: loss rel err {loss_rel:.3g} > {LOSS_TOL}")
        ph.check(all(x == x and abs(x) < float("inf") for x in k_loss), f"[train] {arm}: non-finite loss")
        for name in names:
            ph.check(fwd[name] > 0, f"[train] {arm}: kernel {name} never launched")
            if name in WITH_KERNEL_BWD:
                ph.check(bwd[name] > 0, f"[train] {arm}: kernel {name} never launched on the backward pass")
        for k, v in fwd.items():
            fwd_total[k] = fwd_total.get(k, 0) + v
        for k, v in bwd.items():
            bwd_total[k] = bwd_total.get(k, 0) + v
        print(
            f"[train] {arm}: {TRAIN_STEPS} steps, step-0 grad_rel_err={grad_rel:.3g} "
            f"max loss_rel_err={loss_rel:.3g} loss[0]={k_loss[0]:.6g} loss[-1]={k_loss[-1]:.6g} "
            f"median step ms kernel={statistics.median(k_ms):.4f} plain={statistics.median(p_ms):.4f} | "
            f"launches fwd {dict((k, v) for k, v in fwd.items() if v)} bwd {dict((k, v) for k, v in bwd.items() if v)}",
            flush=True,
        )
        profiled.append((arm, names, k_state, k_step))
    for prof in profiled:
        _profile_train(ph, dev, batches, *prof)
    _sensitivity(dev, batches)
    return fwd_total, bwd_total


def _sensitivity(dev, batches):
    """Arm (a) at the paper's peak lr: kernel route vs plain route, and the
    plain route vs itself from parameters perturbed by 1e-7 (the yardstick:
    how far rounding-level differences grow in TRAIN_STEPS steps)."""
    loss_kw = ARMS["a bt r_sum b=128 q=2"][0]
    losses = lambda impl, **kw: _train_route(dev, loss_kw, impl, batches, lr=SENSITIVITY_LR, **kw)[1]
    plain, kern, nudged = losses("plain"), losses(None), losses("plain", perturb=1e-7)
    print(
        f"[train] sensitivity arm a, peak lr {SENSITIVITY_LR}: max loss rel diff kernel vs plain="
        f"{_max_rel(kern, plain):.3g}; plain vs plain with params x (1 + 1e-7 noise)={_max_rel(nudged, plain):.3g} "
        f"(unchecked: the trajectory's own sensitivity)",
        flush=True,
    )


def _profile_train(ph: Phase, dev, batches, arm, names, state, step):
    """PROFILE_STEPS warmed steps of one arm under the profiler: wall time vs
    summed device time (idle share), the arm's kernels' device ms and the
    largest device items."""
    import torch

    from repro_torch import kernels

    wall = [0.0]

    def run():
        t0 = time.perf_counter()
        s = state
        for i in range(PROFILE_STEPS):
            s, _ = step(s, batches[i % len(batches)])
        torch.cuda.synchronize()
        wall[0] = time.perf_counter() - t0

    kernels.reset_launch_counts()
    events = _device_events(run)
    counts = kernels.launch_counts()
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    wall_ms = wall[0] * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    ours = _ported_ms(ph, events, counts, names, f"train {arm}")
    for name in names:
        ph.check(ours[name][0] > 0, f"[profile] train {arm}: no device time of {name}")
    print(
        f"[profile] train {arm}: {PROFILE_STEPS} steps wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.4f} "
        f"idle_share={1 - busy_ms / wall_ms:.4f} device events={len(events)} | ported kernels ms: "
        + " ".join(f"{k}={ms:.4f} ({n} device launches)" for k, (ms, n) in ours.items())
        + " | top: " + "; ".join(f"{n[:60]}={us / 1e3:.4f}ms" for n, us in top),
        flush=True,
    )


# ---------------------------------------------------------------------------
# phase 5: paged continuous-batching LM serving of gemma2-2b at full width
# ---------------------------------------------------------------------------


def _lm_model(dev, dtype):
    """gemma2-2b at its published width and depth in ``dtype``, random
    weights from ``init_params(seed=0)``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("gemma2-2b"), param_dtype=dtype, compute_dtype=dtype)
    return cfg, init_params(cfg, seed=SEED, device=dev)


class _CheckedSteps:
    """Stands in for ``engine.step_logits``: every decode tick runs first on
    the plain (gather) route from a clone of the pool, then on the engine's
    own route on the pool itself.  Records the worst logit difference over
    the live lanes and, per (request, token index), the plain route's top-2
    logit gap and both routes' argmax.  The plain re-runs launch no kernel."""

    def __init__(self, engine):
        self.engine = engine
        self.orig = engine.step_logits
        self.req_index = {}
        self.max_abs = 0.0
        self.max_rel = 0.0
        self.ticks = 0
        self.steps = {}
        engine.step_logits = self

    def __call__(self, caches, lens, toks, block_tables, impl=None):
        import torch

        clone = {name: {k: v.clone() for k, v in leafs.items()} for name, leafs in caches.items()}
        p_logits = self.orig(clone, lens, toks, block_tables, "plain")[0]
        del clone
        logits, hidden, caches = self.orig(caches, lens, toks, block_tables, impl)
        pool = self.engine.pool
        active = pool.active_indices()
        idx = torch.tensor(active, device=logits.device)
        kl, pl = logits[idx], p_logits[idx]
        diff = float((kl - pl).abs().max())
        self.max_abs = max(self.max_abs, diff)
        self.max_rel = max(self.max_rel, diff / max(1.0, float(pl.abs().max())))
        top2 = torch.topk(pl, 2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        pa, ka = pl.argmax(-1).tolist(), kl.argmax(-1).tolist()
        for j, i in enumerate(active):
            slot = pool[i]
            self.steps[(self.req_index[id(slot.future)], len(slot.emitted))] = (gaps[j], pa[j], ka[j])
        self.ticks += 1
        return logits, hidden, caches


def _lm_service(cfg, params, dev, n_slots, max_len, max_prompt, probe=False, record=False, **engine_kw):
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.serve.engine import ContinuousLMEngine
    from repro_torch.serve.probes import DecorrProbe
    from repro_torch.serve.service import LMService

    engine = ContinuousLMEngine(cfg, params, n_slots=n_slots, max_len=max_len, max_prompt_len=max_prompt,
                                 device=dev, **engine_kw)
    pr = DecorrProbe(DecorrConfig(style="vic", reg="sum", q=2), perm_seed=SEED, device=dev) if probe else None
    return LMService(engine, probe=pr, record_probe_rows=record).warmup()


def _lm_drive(service, stream, checked=None):
    """Submit the whole stream, drain it; returns (outputs, wall s, futures)."""
    import torch

    futs = [service.submit(t, m) for t, m in stream]
    if checked is not None:
        checked.req_index = {id(f): i for i, f in enumerate(futs)}
    t0 = time.perf_counter()
    service.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [f.result(timeout=60) for f in futs], wall, futs


def _lm_checked_run(ph, tag, cfg, params, dev, stream, n_slots, max_len, max_prompt, **engine_kw):
    """Checks (a)-(c) of one f32 workload; returns the kernel run's launch
    counts and its decode ticks."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.serve.loadgen import lm_probe_oracle_err

    shape = dict(n_slots=n_slots, max_len=max_len, max_prompt=max_prompt)
    # (a) the dense engine vs the paged engine on the plain route, bit for bit
    dense, _, _ = _lm_drive(_lm_service(cfg, params, dev, **shape), stream)
    plain_svc = _lm_service(cfg, params, dev, paged=True, page_size=LM_PAGE, impl="plain", **shape, **engine_kw)
    plain, _, _ = _lm_drive(plain_svc, stream)
    bad = [i for i, (a, b) in enumerate(zip(dense, plain)) if not np.array_equal(a, b)]
    ph.check(not bad, f"[lm] {tag}: (a) paged plain-route tokens differ from the dense engine's in requests {bad}")
    print(f"[lm] {tag}: (a) paged plain route == dense engine, bit for bit, in "
          f"{len(stream) - len(bad)}/{len(stream)} requests ({sum(len(o) for o in plain)} tokens)", flush=True)
    del plain_svc

    # (b) + (c) the kernel route, each tick checked against the plain route
    svc = _lm_service(cfg, params, dev, probe=True, record=True, paged=True, page_size=LM_PAGE, **shape, **engine_kw)
    checked = _CheckedSteps(svc.engine)
    kernels.reset_launch_counts()
    kern, wall, _ = _lm_drive(svc, stream, checked)
    counts = kernels.launch_counts()
    ticks = svc.engine.pool.steps
    ph.check(checked.max_rel <= LOGIT_TOL,
             f"[lm] {tag}: (b) kernel vs plain logits rel {checked.max_rel:.3g} > {LOGIT_TOL}")
    ph.check(counts["paged_attention"] > 0 and counts["paged_attention"] == cfg.n_layers * ticks,
             f"[lm] {tag}: paged_attention launched {counts['paged_attention']} times in {ticks} ticks "
             f"(expected {cfg.n_layers} per tick)")
    for name in LM_PROBE_KERNELS:
        ph.check(counts[name] > 0, f"[lm] {tag}: the probe never launched {name} in the kernel-route run")
    exempt = 0
    for r, (k, p) in enumerate(zip(kern, plain)):
        if np.array_equal(k, p):
            continue
        n = min(len(k), len(p))
        t = int(np.argmax(k[:n] != p[:n])) if np.any(k[:n] != p[:n]) else n
        gap = checked.steps.get((r, t), (None,))[0]
        ok = gap is not None and gap < 2 * checked.max_abs
        exempt += ok
        print(f"[lm] {tag}: (c) request {r} first differs at token {t}: plain top-2 gap "
              f"{'n/a' if gap is None else f'{gap:.4g}'} vs 2 x logit diff {2 * checked.max_abs:.4g} "
              f"-> {'exempt from here on' if ok else 'FAIL'}", flush=True)
        ph.check(ok, f"[lm] {tag}: (c) request {r} differs at token {t} with plain top-2 gap {gap}")
    m = svc.metrics()
    err = lm_probe_oracle_err(svc)
    ph.check(err is not None and err < LM_PROBE_TOL, f"[lm] {tag}: probe vs oracle {err} (limit {LM_PROBE_TOL})")
    ph.check(m["dispatch_errors"] == 0, f"[lm] {tag}: dispatch_errors={m['dispatch_errors']}")
    ph.check(all(np.isfinite(v) for k, v in m.items() if k.startswith("decorr_")), f"[lm] {tag}: probe not finite")
    print(f"[lm] {tag}: (b) {checked.ticks} ticks, kernel vs plain logits max_abs={checked.max_abs:.4g} "
          f"rel={checked.max_rel:.4g}; (c) {len(stream) - exempt}/{len(stream)} requests' tokens identical, "
          f"{exempt} exempt; paged_attention launches={counts['paged_attention']} over {ticks} ticks "
          f"({counts['paged_attention'] / max(ticks, 1):.1f}/tick); probe launches "
          + ", ".join(f"{k}={counts[k]}" for k in LM_PROBE_KERNELS) + f"; probe_steps={m.get('decorr_probe_steps', 0):.0f} "
          f"probe_oracle_rel_err={err}; dispatch_errors={m['dispatch_errors']:.0f}; "
          f"peak pages={m['paged_pages_peak']:.0f} of {m['paged_pages_total']:.0f}; wall_s={wall:.3f}", flush=True)
    return counts


def _lm_timed(ph, cfg, params, dev, stream, max_len, max_prompt):
    """The config's own dtype on the kernel route: tok/s, TTFT, decode tick
    and prefill ms; then a profiled window of ticks and the kernel-vs-plain
    logit difference on a live pool (reported, not gated).  Returns the
    run's launch counts (the main path's)."""
    import statistics

    import numpy as np
    import torch

    from repro_torch import kernels

    svc = _lm_service(cfg, params, dev, n_slots=LM_SLOTS, max_len=max_len, max_prompt=max_prompt,
                      probe=True, paged=True, page_size=LM_PAGE)
    eng = svc.engine
    times = {"decode": [], "insert": []}

    def timed(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)  # both end in a host sync (token ids to the host)
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    eng.decode_step, eng.insert = timed("decode", eng.decode_step), timed("insert", eng.insert)
    kernels.reset_launch_counts()
    outs, wall, futs = _lm_drive(svc, stream)
    counts = kernels.launch_counts()
    ticks = eng.pool.steps
    m = svc.metrics()
    ttft = np.asarray([f.ttft_s for f in futs]) * 1e3
    n_tok = sum(len(o) for o in outs)
    ph.check(counts["paged_attention"] == cfg.n_layers * ticks > 0,
             f"[lm] bf16: paged_attention launched {counts['paged_attention']} times in {ticks} ticks")
    for name in LM_PROBE_KERNELS:
        ph.check(counts[name] > 0, f"[lm] bf16: the probe never launched {name}")
    ph.check(m["dispatch_errors"] == 0, f"[lm] bf16: dispatch_errors={m['dispatch_errors']}")
    ph.check(all(o.shape == (mn,) for o, (_, mn) in zip(outs, stream)), "[lm] bf16: wrong output lengths")
    print(f"[lm] bf16 timed: {len(stream)} requests {n_tok} tokens wall_s={wall:.4f} tok_per_s={n_tok / wall:.1f} "
          f"ttft_p50_ms={np.percentile(ttft, 50):.3f} ttft_p99_ms={np.percentile(ttft, 99):.3f} "
          f"decode_tick_ms median={statistics.median(times['decode']):.3f} mean={statistics.mean(times['decode']):.3f} "
          f"({ticks} ticks, occupancy {m['slots_occupancy']:.3f}) prefill_ms median={statistics.median(times['insert']):.3f} "
          f"mean={statistics.mean(times['insert']):.3f} | launches {dict((k, v) for k, v in counts.items() if v)}",
          flush=True)

    # a full pool, then LM_PROFILE_TICKS ticks under the profiler
    rng = np.random.default_rng(SEED + 3)
    for _ in range(LM_SLOTS):
        svc.submit(rng.integers(0, cfg.vocab_size, 24).astype(np.int32), LM_PROFILE_TICKS + 6)
    svc.step()
    wall_box = [0.0]

    def window():
        t0 = time.perf_counter()
        for _ in range(LM_PROFILE_TICKS):
            svc.step()
        torch.cuda.synchronize()
        wall_box[0] = time.perf_counter() - t0

    kernels.reset_launch_counts()
    events = _device_events(window)
    window_counts = kernels.launch_counts()
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    wall_ms = wall_box[0] * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    ported = _ported_ms(ph, events, window_counts, ("paged_attention",) + LM_PROBE_KERNELS, "lm bf16")
    ph.check(ported["paged_attention"][0] > 0, "[profile] lm bf16: no device time of paged_attention")
    print(f"[profile] lm bf16: {LM_PROFILE_TICKS} decode ticks, 8 live slots, wall_ms={wall_ms:.3f} "
          f"device_busy_ms={busy_ms:.4f} idle_share={1 - busy_ms / wall_ms:.4f} device events={len(events)} | "
          + " ".join(f"{k} ms={ms:.4f} ({n} device launches, {window_counts[k]} wrapper launches)"
                     for k, (ms, n) in ported.items())
          + " | top: " + "; ".join(f"{n[:60]}={us / 1e3:.4f}ms" for n, us in top),
          flush=True)

    # kernel vs plain on the live pool, a few ticks (reported, not gated)
    worst = 0.0
    for _ in range(3):
        lens = torch.as_tensor(eng.pool.cache_lens(), device=dev)
        toks = torch.as_tensor(eng.pool.last_tokens(), device=dev)
        bt = torch.as_tensor(eng.pager.block_tables(), device=dev)
        got = {}
        for impl in (None, "plain"):
            clone = {n: {k: v.clone() for k, v in leafs.items()} for n, leafs in eng.caches.items()}
            got[impl] = eng.step_logits(clone, lens, toks, bt, impl)[0]
        worst = max(worst, float((got[None] - got["plain"]).abs().max()) / max(1.0, float(got["plain"].abs().max())))
        svc.step()
    print(f"[lm] bf16: kernel vs plain logits rel diff over 3 live ticks = {worst:.4g} (reported, not gated)", flush=True)
    svc.drain()
    return counts


def phase_lm(ph: Phase, dev):
    """The LM serving path at full width; returns the bf16 run's launch counts."""
    import gc

    import torch

    from repro_torch.serve.loadgen import LMLoadConfig

    load = LMLoadConfig()
    max_len = -(-max(load.max_request_len + 8, 32) // LM_PAGE) * LM_PAGE
    max_prompt = max(load.prompt_lens)
    cfg, params = _lm_model(dev, torch.float32)
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} "
          f"hd={cfg.hd} vocab={cfg.vocab_size} params={cfg.param_count() / 1e9:.3f}B; f32 gate: "
          f"{load.n_requests} requests, {LM_SLOTS} slots, page {LM_PAGE}, max_len {max_len}", flush=True)
    stream = load.request_stream(cfg.vocab_size)
    _lm_checked_run(ph, "f32 24 requests", cfg, params, dev, stream, LM_SLOTS, max_len, max_prompt)
    gc.collect()
    torch.cuda.empty_cache()

    long_load = LMLoadConfig(n_requests=2, prompt_lens=(LONG_PROMPT,), new_tokens=(LONG_NEW,), seed=SEED + 1)
    rows = LONG_PROMPT + LONG_NEW - 1
    total_pages = 2 * (-(-rows // LM_PAGE)) + 1
    print(f"[lm] f32 long context: 2 requests of {LONG_PROMPT} + {LONG_NEW} tokens, max_len {LONG_MAX_LEN}, "
          f"{total_pages} pages of {LM_PAGE} (window {cfg.window_size} on the local layers)", flush=True)
    _lm_checked_run(ph, "f32 long context", cfg, params, dev, long_load.request_stream(cfg.vocab_size), 2,
                    LONG_MAX_LEN, LONG_PROMPT, total_pages=total_pages)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg, params = _lm_model(dev, torch.bfloat16)
    return _lm_timed(ph, cfg, params, dev, stream, max_len, max_prompt)


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
    ph.run("profile", phase_profile, ph, dev)
    train_fwd, train_bwd = ph.run("train", phase_train, ph, dev) or ({}, {})
    lm = ph.run("lm", phase_lm, ph, dev) or {}
    for part in (train_fwd, lm):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    for name in REPLACES:
        ph.check(name in rows, f"no timing row for {name}")
        ph.check(launches.get(name, 0) > 0, f"{name} never launched on the main path")
    for name in WITH_KERNEL_BWD:
        ph.check(train_bwd.get(name, 0) > 0, f"{name} never launched on the training path's backward pass")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    ph.check(smi.returncode == 0, "nvidia-smi failed")
    if ph.failures:
        print(f"[chip_smoke] {len(ph.failures)} check(s) failed: {ph.failures}", flush=True)
        return 1
    line = [dict(rows[name], launches=launches[name], launches_bwd=train_bwd.get(name, 0)) for name in REPLACES]
    print(json.dumps({"kernels": line}))
    print(smi.stdout.strip().splitlines()[0])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
