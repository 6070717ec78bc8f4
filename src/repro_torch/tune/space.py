"""Candidate spaces of the port's tunable choices (port of
``repro/tune/space.py``).

What a Hopper tuner can choose (``tune/__init__.py`` says why):

  kernel             shape                 config keys
  -----------------  --------------------  ------------------------------
  sumvec_fft_plan    (d,)                  dp, d1, d2   (dp > d => padded)
  grouped_block_plan (n, d)                b            (block DFT group size)
  paged_attention    (b, s, kv, hd)        page         (KV tokens per page)
  xcorr_offdiag      (n, d)                the C entry's fixed tile
  cmatmul            (m, k, n)             the C entry's fixed tile
  ctwiddle           (n, d)                the C entry's fixed tile
  pmatmul            (m, k, n)             the C entry's fixed tile
  freq_outer         (f, k, n)             the C entry's fixed tile
  freq_mat           (f, k, n, n2)         the C entry's fixed tile

The two plans are the reference's enumeration, copied exactly, so the port
and the reference rank the same candidates.  ``grouped_block_plan``'s b is
part of the LOSS: it is searched only where a caller leaves b unpinned.
The page candidates are the reference's (multiples of 8 from 8 to 512, no
larger than the context rounded up to 8); the Hopper kernel takes any page
>= 1 (``kernels/csrc/paged_attention.cu``).

Each of the six tile kernels has a one-config space: the tile its C entry
uses (``TILES``, read from the constants of ``kernels/csrc/*.cu``), which
no launch argument can change.  Hopper legality replaces the reference's
lane, sublane and VMEM rules: a config is legal when its shared memory
(``smem_bytes``) fits ``SMEM_BUDGET_BYTES`` and its blocks have at most
``MAX_THREADS`` threads — and, for a tile kernel, when it is the C entry's
own tile.  Configs are plain ``{str: int}`` dicts, so they round-trip
through the JSON cache unchanged.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from repro_torch.kernels.utils import next_multiple

Config = Dict[str, int]
Shape = Tuple[int, ...]

# dynamic shared memory one H100 block may claim (228 KiB an SM, 1 KiB
# kept by the runtime); every C entry of the port stays under it
SMEM_BUDGET_BYTES = 227 * 1024
MAX_THREADS = 1024
F32 = 4

KERNELS = (
    "xcorr_offdiag",
    "cmatmul",
    "ctwiddle",
    "pmatmul",
    "freq_outer",
    "freq_mat",
    "sumvec_fft_plan",
    "grouped_block_plan",
    "paged_attention",
)
PLAN_KERNELS = ("sumvec_fft_plan", "grouped_block_plan")
TILE_KERNELS = KERNELS[:6]

# The tile each C entry launches, from its constants:
#   xcorr_offdiag.cu: BM x BN = 128 x 128 tiles of C, XK = 32 batch rows a
#     ring stage, STAGES = 3, 256 threads;
#   sumvec_fft.cu cmatmul: column tiles of up to 128 (CM_WIDE chunks of 4),
#     CM_KC = 32 deep stages where B cannot stay resident, CM_STAGES = 2,
#     256 consumer threads + a producer warp; ctwiddle: TW_THREADS = 128
#     column vectors a block, TW_ROWS = 4 rows a thread;
#   grouped_sumvec.cu pmatmul: PM_BM = 16 rows x PM_BN = 132 columns a block,
#     PM_KC = 32 deep stages, PM_STAGES = 4, 128 consumers + a producer warp;
#     freq_outer: output edges of at most FO_EDGE = 64, 128 threads (the
#     register-fed kernel) or 256 (the staged one, FS_STAGES = 4); freq_mat:
#     FM_MAX_ROWS = 128 rows, FM_CS = 64 deep, FM_NT = 64 columns, 128 threads.
TILES: Dict[str, Config] = {
    "xcorr_offdiag": {"bm": 128, "bn": 128, "xk": 32, "stages": 3, "threads": 256},
    "cmatmul": {"tn": 128, "kc": 32, "stages": 2, "threads": 288},
    "ctwiddle": {"rows": 4, "threads": 128},
    "pmatmul": {"bm": 16, "bn": 132, "kc": 32, "stages": 4, "threads": 160},
    "freq_outer": {"edge": 64, "stages": 4, "threads": 256},
    "freq_mat": {"rows": 128, "cs": 64, "nt": 64, "threads": 128},
}

# the reference's page ladder (its sublane tiles), clamped to the context
_PAGE_TILES = (8, 16, 32, 64, 128, 256, 512)
_PAGE_UNIT = 8


# ---------------------------------------------------------------------------
# Hopper resources of one config
# ---------------------------------------------------------------------------


def _cmatmul_smem(shape: Shape, cfg: Config) -> int:
    """The C entry's rule: B's two planes resident beside a ring of whole A
    strips where that fits, else a ring of ``kc``-deep slices of both."""
    m, k, n = shape
    tn, kc, stages = cfg["tn"], cfg["kc"], cfg["stages"]
    cols = min(next_multiple(n, 4), tn)
    bm = 128 // min(16, max(cols // 4, 1)) * 4  # row lanes x 4 rows a thread
    kp = next_multiple(k, 4)
    extra = 128 * 4 * 2 * F32 + (2 * stages + 1) * 8
    resident = (2 * kp * cols + stages * 2 * bm * k) * F32 + extra
    if resident <= SMEM_BUDGET_BYTES:
        return resident
    return stages * (2 * bm * (kc + 4) + 2 * kc * cols) * F32 + extra


def smem_bytes(kernel: str, shape: Shape, cfg: Config) -> int:
    """Shared memory one block of ``kernel`` claims under ``cfg`` at ``shape``."""
    if kernel == "xcorr_offdiag":
        return cfg["stages"] * cfg["xk"] * (cfg["bm"] + cfg["bn"]) * F32 + cfg["stages"] * 8
    if kernel == "cmatmul":
        return _cmatmul_smem(shape, cfg)
    if kernel == "ctwiddle":
        return 0
    if kernel == "pmatmul":
        m, k, n = shape
        stage = cfg["bm"] * (cfg["kc"] + 4) + cfg["kc"] * cfg["bn"]
        ring = (cfg["stages"] * stage + (8 * 4 + 1) * 32 * 2) * F32 + 2 * cfg["stages"] * 8
        # A's 16 rows stay resident where K <= 256
        return ring + ((cfg["bm"] * 256 + 4) * F32 if k <= 256 else 0)
    if kernel == "freq_outer":
        f, k, n = shape
        if n < cfg["edge"]:  # the register-fed kernel: one reduction buffer
            return 128 * 4 * 4 * F32
        return 128 + max(cfg["stages"] * (128 * (cfg["edge"] + cfg["edge"] // 2) + 64), cfg["threads"] * 64) * F32
    if kernel == "freq_mat":
        return (4 + cfg["rows"] * (cfg["cs"] + 4) + cfg["cs"] * cfg["nt"]) * F32
    if kernel in PLAN_KERNELS:
        # plans choose no tile: the kernels they launch claim their own
        return 0
    if kernel == "paged_attention":
        b, s, kv, hd = shape
        vec = -(-hd // 32)
        warps = 16 if vec <= 16 else 8
        # the warps' online-softmax states and accumulators, merged in
        # shared memory (one query row a kv head: n_rep is not in the shape)
        return (warps * (3 + 32 * vec) + 1) * F32
    raise KeyError(kernel)


def threads(kernel: str, shape: Shape, cfg: Config) -> int:
    """Threads of one block of ``kernel`` under ``cfg``."""
    if kernel in TILES:
        return cfg["threads"]
    if kernel == "paged_attention":
        return 32 * (16 if -(-shape[3] // 32) <= 16 else 8)
    return 0


def is_legal(kernel: str, shape: Shape, cfg: Config) -> bool:
    """Plan consistency, the C entry's own tile, and Hopper's limits."""
    if kernel == "sumvec_fft_plan":
        (d,) = shape
        return is_legal_plan(d, cfg)
    if kernel == "grouped_block_plan":
        n, d = shape
        return 2 <= cfg["b"] <= d
    if kernel == "paged_attention":
        if cfg["page"] < 1:
            return False
    elif kernel in TILES:
        if cfg != TILES[kernel]:
            return False
    else:
        raise KeyError(kernel)
    return smem_bytes(kernel, shape, cfg) <= SMEM_BUDGET_BYTES and threads(kernel, shape, cfg) <= MAX_THREADS


# ---------------------------------------------------------------------------
# Plans: the four-step factorization and the grouped block size
# ---------------------------------------------------------------------------


def balanced_factors(x: int) -> Tuple[int, int]:
    """(d1, d2), d1 <= d2, d1 * d2 == x, d1 as large as possible."""
    for d1 in range(int(math.isqrt(x)), 0, -1):
        if x % d1 == 0:
            return d1, x // d1
    return 1, x


def _divisor_factorizations(x: int, limit: int = 8) -> List[Tuple[int, int]]:
    out = []
    for d1 in range(int(math.isqrt(x)), 0, -1):
        if x % d1 == 0:
            out.append((d1, x // d1))
        if len(out) >= limit:
            break
    return out


def padded_plan_candidates(d: int, scan: int = 256, keep: int = 4) -> List[Config]:
    """Tile-friendly padded DFT lengths dp >= 2d - 1 with balanced factors.

    Zero-padding the feature axis to dp and folding the linear correlation
    back to d circular lags is exact (see ``kernels/sumvec_fft/ops.py``), so
    any dp here preserves the loss; a bounded window above 2d - 1 is scanned
    for highly composite lengths and the cheapest few by the four-step FLOP
    proxy dp * (d1 + d2) are kept.
    """
    lo = max(2 * d - 1, 2)
    scored = []
    for dp in range(lo, lo + scan):
        d1, d2 = balanced_factors(dp)
        if d1 < max(2, math.isqrt(dp) // 4):
            continue  # too lopsided to beat the direct DFT reliably
        scored.append((dp * (d1 + d2), {"dp": dp, "d1": d1, "d2": d2}))
    scored.sort(key=lambda t: (t[0], t[1]["dp"]))
    return [cfg for _, cfg in scored[:keep]]


def is_legal_plan(d: int, cfg: Config) -> bool:
    """A four-step plan is legal when dp == d1 * d2 and either exact
    (dp == d) or linear-correlation safe (dp >= 2d - 1, no wraparound)."""
    dp, d1, d2 = cfg["dp"], cfg["d1"], cfg["d2"]
    if d1 * d2 != dp or d1 < 1 or d2 < 1:
        return False
    return dp == d or dp >= 2 * d - 1


def sumvec_fft_plan_candidates(d: int) -> List[Config]:
    """All legal four-step plans for length d, exact factorizations first
    (the balanced default is the first of them)."""
    out: List[Config] = [{"dp": d, "d1": d1, "d2": d2} for d1, d2 in _divisor_factorizations(d)]
    out.extend(padded_plan_candidates(d))
    return [cfg for cfg in out if is_legal_plan(d, cfg)]


def grouped_block_size_candidates(d: int) -> List[int]:
    """Legal grouped-regularizer block sizes b for width d: powers of two
    from 2 up to d, plus d itself (== ungrouped Eq. 6)."""
    out = []
    b = 2
    while b < d:
        out.append(b)
        b *= 2
    out.append(d)
    return out


# ---------------------------------------------------------------------------
# Candidate enumeration + defaults
# ---------------------------------------------------------------------------


def candidates(kernel: str, shape: Shape) -> List[Config]:
    """All legal configs for ``kernel`` at ``shape`` (the default included)."""
    if kernel == "sumvec_fft_plan":
        out = sumvec_fft_plan_candidates(*shape)
    elif kernel == "grouped_block_plan":
        out = [{"b": b} for b in grouped_block_size_candidates(shape[1])]
    elif kernel == "paged_attention":
        cap = next_multiple(shape[1], _PAGE_UNIT)
        out = [{"page": p} for p in sorted({min(t, cap) for t in _PAGE_TILES})]
    elif kernel in TILES:
        out = [dict(TILES[kernel])]
    else:
        raise KeyError(kernel)
    default = default_config(kernel, shape)
    if default not in out:
        out.append(default)
    return [cfg for cfg in out if is_legal(kernel, shape, cfg)]


def default_config(kernel: str, shape: Shape) -> Config:
    """The choice made without tuning: the balanced exact plan, the
    paper's b (the largest legal one <= 128), vLLM's 16-token page clamped
    to short contexts (all three the reference's), and each tile kernel's
    own tile."""
    if kernel == "sumvec_fft_plan":
        (d,) = shape
        d1, d2 = balanced_factors(d)
        return {"dp": d, "d1": d1, "d2": d2}
    if kernel == "grouped_block_plan":
        return {"b": max(b for b in grouped_block_size_candidates(shape[1]) if b <= 128)}
    if kernel == "paged_attention":
        return {"page": min(16, next_multiple(shape[1], _PAGE_UNIT))}
    if kernel in TILES:
        return dict(TILES[kernel])
    raise KeyError(kernel)
