"""Readings that a cell's correctness limits are set from, on the card.

    python3 bench/calibrate.py --workload <name> --seeds 11-22 --control 11-13 \
        --fault half_batch:11-13 --out chiprun_out/calib_<name>.json

For every seed of ``--seeds`` the system's first steps (the cell's own
set-up, at its own sizes, no window) against the float32 reference: the
compared numbers of sound runs, whose largest is a limit's lower reading.
For the seeds of ``--control`` the control, the reference at the precision
below the configuration's (TF32 for float32, float8 for bfloat16), against
the float32 reference; for ``--fault NAME:SEEDS`` the system with the fault
planted (``benchlib/faults.py``).  Their smallest readings are a limit's
upper ones.  Prints a line a reading and writes every reading and the
summary to ``--out``.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def _seeds(text: str):
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 bench/calibrate.py", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", action="append", default=[], help="NAME:SEEDS")
    ap.add_argument("--out", required=True)
    ap.add_argument("--detail", action="store_true", help="print every leaf's readings")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.benchlib import compare, faults, spec

    dev = torch.device("cuda")
    c = spec.cell(ROOT, args.workload)
    drv = spec.driver(c)
    dtype = c.config.get("compute_dtype", c.config.get("dtype", "float32"))
    control = CONTROL[dtype]
    control_seeds = set(_seeds(args.control))
    fault_seeds = {name: set(_seeds(s)) for name, s in (f.split(":", 1) for f in args.fault)}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def program(seed, fault=None):
        with faults.planted(c.traffic["driver"], fault) if fault else contextlib.nullcontext():
            sess = drv.setup(c, seed, dev)
        readings = sess.readings
        sess.close()
        del sess
        free()
        return readings

    rows = []

    def note(kind, seed, nums, **extra):
        row = {"kind": kind, "seed": seed, **nums, **extra}
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in _seeds(args.seeds):
        prog = program(seed)
        t0 = time.perf_counter()
        ref = drv.reference(c, seed, dev, "fp32")
        ref_s = time.perf_counter() - t0
        free()
        note("program", seed, compare.numbers(prog, ref), reference_s=ref_s, losses=prog["losses"],
             ref_losses=ref["losses"])
        if args.detail:
            for leaf in sorted(ref["first_grads"]):
                print(json.dumps({"leaf": leaf, "first": [prog["first_grads"][leaf], ref["first_grads"][leaf]],
                                  "change": [prog["changes"][leaf], ref["changes"][leaf]],
                                  "raw": ref["grads"][leaf]}), flush=True)
        if seed in control_seeds:
            ctl = drv.reference(c, seed, dev, control)
            free()
            note(f"control_{control}", seed, compare.numbers(ctl, ref), losses=ctl["losses"])
        for name, seeds in fault_seeds.items():
            if seed in seeds:
                note(f"fault_{name}", seed, compare.numbers(program(seed, name), ref))
    summary = {}
    for kind in sorted({r["kind"] for r in rows}):
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(r[k] for r in rows if r["kind"] == kind) for k in ("loss_rel", "grad_gap",
                                                                                      "change_gap")}
    info = {"workload": c.name, "device": torch.cuda.get_device_name(dev), "summary": summary, "rows": rows}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(info, indent=1))
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
