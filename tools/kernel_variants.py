#!/usr/bin/env python3
"""Design search for one CUDA kernel source: text variants built side by side.

    python3 tools/kernel_variants.py [--cases 'prefix|prefix'] [--rounds 2] SPEC.json

SPEC.json maps a variant name to ``[family, [[old, new], ...], {name: value}]``:
the source ``src/repro_torch/kernels/csrc/<family>.cu`` with each ``old``
text replaced by ``new`` (every ``old`` must occur), and the module
constants its wrapper must agree on, by dotted name (for example
``{"repro_torch.kernels.paged_attention.kernel.CHUNK": 512}``).  An empty
replacement list is the source as it stands; a variant that names no
value for a constant another one sets runs with the source tree's value.
All variants compile at once (``nvcc -Xptxas -v``, the package's flags) into
``build/variants/<name>/``; each prints its registers and any spills.  Then,
``--rounds`` times in turns (forward order, then reversed), each variant's
library is swapped into the package's loader and every phase-1 case of
``chip_smoke._kernel_cases`` of the source's kernels (or those whose label
starts with one of ``--cases``) runs once against its plain version, once
more for a bit-for-bit rerun check, then under the profiler: JSON lines
``{"variant", "round", "case", "rel", "rerun_equal", "dev_ms",
"bound_ms"}``, and a summary line per (variant, case).

Needs a CUDA card and ``nvcc``; exits 1 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "variants")


def _build(spec, build):
    """Compile every variant at once; {name: library path} of those that built."""
    procs = {}
    for name, (fam, subs, _) in spec.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        src = open(os.path.join(build.CSRC, f"{fam}.cu")).read()
        for old, new in subs:
            if old not in src:
                raise ValueError(f"variant {name}: {old!r} not in {fam}.cu")
            src = src.replace(old, new)
        path = os.path.join(d, f"{fam}.cu")
        with open(path, "w") as f:
            f.write(src)
        for h in os.listdir(build.CSRC):
            if h.endswith(".cuh"):
                with open(os.path.join(d, h), "w") as f:
                    f.write(open(os.path.join(build.CSRC, h)).read())
        lib = os.path.join(d, f"lib{fam}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, path]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or ("spill" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln)]
        ptxas = lines if proc.returncode == 0 else log[-3000:]
        print(json.dumps({"variant": name, "rc": proc.returncode, "ptxas": ptxas}), flush=True)
        if proc.returncode == 0:
            built[name] = lib
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("spec")
    ap.add_argument("--cases", default="", help="'|'-separated label prefixes (default: every case of the kernel)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import resolve_device
    from repro_torch.kernels import build

    with open(args.spec) as f:
        spec = json.load(f)
    prefixes = [p for p in args.cases.split("|") if p]
    built = _build(spec, build)
    dev = resolve_device("cuda")
    build.build_all()
    cases = cs._kernel_cases(dev)
    # every constant a variant sets, at its value in the source tree: a
    # variant that does not name one runs with that value
    consts = {c for _, _, named in spec.values() for c in named}
    default = {c: getattr(importlib.import_module(c.rsplit(".", 1)[0]), c.rsplit(".", 1)[1]) for c in consts}
    times = {}
    for r in range(args.rounds):
        for name in (list(built) if r % 2 == 0 else list(reversed(list(built)))):
            fam, _, named = spec[name]
            build._LIBS[fam] = ctypes.CDLL(built[name])
            for key in [k for k in build._FNS if k[0] == fam]:
                del build._FNS[key]
            for dotted, value in {**default, **named}.items():
                module, const = dotted.rsplit(".", 1)
                setattr(importlib.import_module(module), const, value)
            for kernel, label, kern, plain, _, nbytes, flops in cases:
                if not cs.SOURCES[kernel].endswith(f"/{fam}.cu"):
                    continue
                if prefixes and not any(label.startswith(p) for p in prefixes):
                    continue
                got, want = kern(), plain()
                torch.cuda.synchronize()
                rel = cs._max_err(got, want)[1]
                again = kern()
                pairs = zip(again, got) if isinstance(got, tuple) else [(again, got)]
                same = all(torch.equal(a, b) for a, b in pairs)
                ms = cs._device_ms(kern)
                times.setdefault((name, label), []).append(ms)
                print(json.dumps({"variant": name, "round": r, "case": label, "rel": rel, "rerun_equal": same,
                                  "dev_ms": ms, "bound_ms": cs._bound(nbytes, flops)[0]}), flush=True)
    for (name, label), ms in times.items():
        print(f"SUMMARY {name:<12} {label[:60]:<60} " + " ".join("none" if x is None else f"{x:.5f}" for x in ms),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
