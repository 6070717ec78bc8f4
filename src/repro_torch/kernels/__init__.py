"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``launch_counts`` / ``reset_launch_counts`` read and clear every kernel
wrapper's launch counter, so a run can show the path went through the
kernels (``chip_smoke.py`` clears them just before driving the service).
"""

from __future__ import annotations

from typing import Dict


def _wrappers():
    from repro_torch.kernels.grouped_sumvec import kernel as gk
    from repro_torch.kernels.sumvec_fft import kernel as fk

    return {
        "cmatmul": fk.cmatmul,
        "ctwiddle": fk.ctwiddle,
        "pmatmul": gk.pmatmul,
        "freq_outer": gk.freq_outer,
    }


def launch_counts() -> Dict[str, int]:
    """{kernel name: CUDA launches since the last reset}."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for fn in _wrappers().values():
        fn.launches = 0
