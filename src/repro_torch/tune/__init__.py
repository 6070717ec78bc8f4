"""repro_torch.tune — what the port tunes, and the dispatch that serves it
(port of ``repro.tune``).

What a Hopper tuner tunes.  Each redesigned kernel's C entry fixes its own
tiles from the sizes it is given (``kernels/csrc/*.cu``; e.g.
``grouped_sumvec_pmatmul(a, b, c, M, K, N, stream)``), and no option
selects a kernel, so no launch takes a tile argument.  The tunable set is:

  * ``sumvec_fft_plan`` — the four-step split (dp, d1, d2) of the ungrouped
    R_sum; every legal plan computes the same loss;
  * ``grouped_block_plan`` — the grouped regularizer's block size b, which
    is part of the LOSS: searched only where a caller leaves b unpinned;
  * ``paged_attention`` — the KV page size, fixed where the pool is built
    (``kernels/paged_attention/ops.auto_page_size``).

The six tile kernels (``xcorr_offdiag``, ``cmatmul``, ``pmatmul``,
``ctwiddle``, ``freq_outer``, ``freq_mat``) each have a one-config space,
the tile their C entry uses: the tuner times it and reports "kept
default".  Making a tile a launch argument would give them a search.

Layers:

  * ``space``    — candidates per kernel, defaults, Hopper legality (shared
                   memory, threads);
  * ``cost``     — analytic (H100 roofline + launches), dry (counted FLOPs
                   of the plain route) and measured (CUDA events) tiers;
  * ``cache``    — the persistent JSON cache, one file per backend
                   (``torch-cuda-sm90``, ``torch-cpu``);
  * ``dispatch`` — ``best_config`` (override > memo > disk > analytic) and
                   ``best_impl`` (kernel on CUDA, plain on the CPU);
  * ``tuner``    — ``tune``, used by ``python -m repro_torch.tune`` and
                   ``decorr.warmup_tune_cache``.
"""

from repro_torch.tune.dispatch import (
    best_config,
    best_impl,
    canonical_shape,
    clear_memory_cache,
    clear_override,
    override,
    set_override,
)
from repro_torch.tune.space import (
    KERNELS,
    SMEM_BUDGET_BYTES,
    candidates,
    default_config,
    grouped_block_size_candidates,
    is_legal,
    smem_bytes,
)


def tune(*args, **kwargs):
    """Lazy proxy for :func:`repro_torch.tune.tuner.tune` (keeps the kernel
    modules out of this package's import time — they import dispatch)."""
    from repro_torch.tune import tuner

    return tuner.tune(*args, **kwargs)


__all__ = [
    "best_config",
    "best_impl",
    "canonical_shape",
    "candidates",
    "clear_memory_cache",
    "clear_override",
    "default_config",
    "grouped_block_size_candidates",
    "is_legal",
    "KERNELS",
    "override",
    "set_override",
    "SMEM_BUDGET_BYTES",
    "smem_bytes",
    "tune",
]
