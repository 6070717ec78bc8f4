"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every kernel wrapper carries two counters:

  * ``launches`` — CUDA launches of its kernel, forward or backward;
  * ``launches_bwd`` — launches on a backward pass that belong to it: its
    own kernel's, and those its vjp makes with another kernel
    (``freq_outer``'s vjp is two ``freq_mat`` launches, which count under
    both names).

``launch_counts`` / ``backward_launch_counts`` read them and
``reset_launch_counts`` clears both, so a run can show that the path, and
its gradient, went through the kernels (``chip_smoke.py`` clears them just
before driving each path).  One module lock guards every update, so
threads launching at once (the serving fabric's replicas) lose no count.
"""

from __future__ import annotations

import threading
from typing import Dict

_COUNT_LOCK = threading.Lock()


def _wrappers():
    from repro_torch.kernels.grouped_sumvec import kernel as gk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.sumvec_fft import kernel as fk
    from repro_torch.kernels.xcorr_offdiag import kernel as xk

    return {
        "cmatmul": fk.cmatmul,
        "ctwiddle": fk.ctwiddle,
        "pmatmul": gk.pmatmul,
        "freq_outer": gk.freq_outer,
        "freq_mat": gk.freq_mat,
        "xcorr_offdiag": xk.off_diagonal_sq_sum_raw,
        "paged_attention": pk.paged_decode_attention,
    }


def launch_counts() -> Dict[str, int]:
    """{kernel name: CUDA launches since the last reset}."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def backward_launch_counts() -> Dict[str, int]:
    """{kernel name: backward-pass launches since the last reset}."""
    return {name: fn.launches_bwd for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch counters to 0."""
    with _COUNT_LOCK:
        for fn in _wrappers().values():
            fn.launches = 0
            fn.launches_bwd = 0


def count_launch(fn, bwd_owner=None) -> None:
    """Add one launch of ``fn``'s kernel; ``bwd_owner`` (a wrapper, set on a
    backward pass) also gets it under ``launches_bwd``, as does ``fn``."""
    with _COUNT_LOCK:
        fn.launches += 1
        if bwd_owner is not None:
            fn.launches_bwd += 1
            if bwd_owner is not fn:
                bwd_owner.launches_bwd += 1
