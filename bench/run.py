"""Run one cell of the benchmark of ``repro_torch`` once on this machine's card.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix,
limits and metrics come from ``BENCHMARK.json`` and the files under
``bench/`` (``bench/benchlib/spec.py``).  The run builds the system's
training step from the seed, drives its first steps, times ``--seconds``
of further steps, and checks what those first steps produced against a
plain reference (``bench/benchlib/harness.py``).  The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics, or with ``--trace 1`` the per-layer
ones), ``device``, with ``--trace 1`` a ``breakdown``, and ``checks`` last:
each compared number beside its limit, which also close standard error.

The run needs a CUDA card (it exits with code 2 and prints no result
without one) and exits with code 3 if JAX or the JAX package was loaded.
Build and kernel caches go to fixed directories under ``build/`` in the
checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _caches() -> None:
    """Every build and kernel cache in a fixed directory of the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["REPRO_TUNE_CACHE"] = str(build / "tune")
    os.environ["USE_FLAX"] = "0"
    # one process with few threads: the host's own arithmetic is small, and
    # an idle thread pool only adds noise to a host-paced step
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def loaded_forbidden():
    """Top-level names of loaded modules that are JAX's or the JAX package's."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or "not read"."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip() or "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 bench/run.py", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    torch.set_num_threads(1)
    from bench.benchlib import harness, spec

    chips = spec.cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), root=ROOT,
                              device="cuda", t_start=T_START)
    found = loaded_forbidden()
    if found:
        print(f"JAX or the JAX package was loaded in the benchmark's process: {found}", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = _power_limit()
    result["checks"] = result.pop("checks")
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
