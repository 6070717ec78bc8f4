"""Multi-pod dry run (port of ``repro/launch/dryrun.py``): analyse every
(architecture x input shape x mesh) cell's per-rank program; record its
memory, FLOPs, bytes, collective bytes and roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --arch gemma2-2b --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun_results

Where the reference forces 512 placeholder XLA devices before any import,
this module (and only this one) initialises a ``fake`` process group
(``torch.testing._internal.distributed.fake_pg``) of 256 or 512 ranks for
each cell's mesh: ``make_production_mesh`` then builds the production
``DeviceMesh`` and every collective returns at once without moving data.
Nothing is allocated: the inputs are ``launch/specs``' fake tensors and the
cell runs under ``launch/hlo_cost.analyze``.  A train cell of more than 4
microbatches is analysed at 3 and 4 of them and extended by the rest
(``analyze_cell``: the same record, sooner).

What runs is the PORT's per-rank program, not the reference's: the port has
no GSPMD partitioner.  Every train cell runs the port's 2-D step
(``parallel/fsdp_tp``: the rank holds its block of every parameter and
both AdamW moments under the specs' layout, FSDP over ``data``, TP and the
MoE experts over ``model``, the batch over ``("pod", "data")``), recorded
as ``"layout": "2d"``; its ``argument_bytes`` then equal
``reference_argument_bytes``, what the specs' 2-D layout holds a rank.
Every prefill and decode cell (``long_500k`` too) runs the 2-D serving
steps of ``train/serve`` on the rank's blocks of the parameters
(``fsdp_tp.place_params``), of the decode state (``place_caches``: the
slots over ``("pod", "data")``, KV rows and Mamba channels over ``model``,
RWKV6 state whole on every ``model`` rank) and of the prompts:
``"layout": "2d"`` too, the argument bytes the specs'.

``--device`` defaults to ``cuda`` (fake CUDA tensors: the kernel route, each
hand-written kernel's launches counted; a machine without CUDA raises, as
every entry point of the port does); ``--device cpu`` analyses the plain
route.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import hlo_cost
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import _make_mesh, make_production_mesh
from repro_torch.optim.optimizers import adamw, warmup_cosine
from repro_torch.parallel import fsdp_tp
from repro_torch.train.serve import make_decode_step, make_prefill_step
from repro_torch.train.step import make_train_step
from repro_torch.train.train_state import TrainState

# the card's memory, as the dry run's fit test takes it
HBM_BYTES = 80e9


def fake_world(n_ranks: int) -> None:
    """A ``fake`` process group of ``n_ranks`` (rank 0) as the default
    group, replacing an earlier fake one of another size; raises if a real
    group is initialised (the dry run never replaces it)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a fake process group, and a real one is initialised")
        if dist.get_world_size() == n_ranks:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_ranks)


def num_microbatches_for(cfg, shape: S.ShapeSpec, mesh) -> int:
    if shape.kind != "train":
        return 1
    sizes = S.mesh_sizes(mesh)
    n_data = 1
    for a in ("pod", "data"):
        if a in sizes:
            n_data *= sizes[a]
    per_dev = max(1, shape.global_batch // n_data)
    params_b = cfg.param_count() / 1e9
    target_per_dev = 1 if params_b > 30 else (4 if params_b > 4 else per_dev)
    micro = max(1, per_dev // target_per_dev)
    while shape.global_batch % micro != 0:
        micro -= 1
    return micro


def _moment_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.optimizer_moment_dtype in (torch.bfloat16, "bfloat16", "bf16") else torch.float32


def _rank_block(spec_tree, axes, mesh):
    """This rank's block of batch specs along the mesh ``axes`` (the batch
    dimension: 1 for M-RoPE positions, else 0), as fake tensors."""
    sizes = S.mesh_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    out = {}
    for k, t in spec_tree.items():
        dim = 1 if k == "positions" and t.dim() == 3 else 0
        shape = list(t.shape)
        if shape[dim] % n == 0 and shape[dim] >= n:
            shape[dim] //= n
        with S.fake_mode():
            out[k] = torch.empty(shape, dtype=t.dtype, device=t.device)
    return out


def _first_rows(block, runs: int, micro: int):
    """The first ``runs`` of ``micro`` equal row blocks of each batch spec."""
    out = {}
    for k, t in block.items():
        dim = 1 if k == "positions" and t.dim() == 3 else 0
        shape = list(t.shape)
        shape[dim] = shape[dim] // micro * runs
        with S.fake_mode():
            out[k] = torch.empty(shape, dtype=t.dtype, device=t.device)
    return out


def _local_bytes(tree) -> int:
    """Bytes one rank holds of every spec in ``tree`` under its sharding."""
    total = 0
    for t in hlo_cost._tensors(tree):
        shape = S.local_shape(t.shape, t.sharding)
        n = 1
        for s in shape:
            n *= s
        total += n * t.element_size()
    return total


def _mesh(multi_pod: bool, mesh_shape):
    if mesh_shape is None:
        fake_world(512 if multi_pod else 256)
        return make_production_mesh(multi_pod=multi_pod)
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    fake_world(math.prod(mesh_shape))
    return _make_mesh(tuple(mesh_shape), axes)


def build_cell(arch: str, shape_name: str, multi_pod: bool, device=None, *, cfg=None, microbatches=None,
               grad_shardings: bool = False, mesh_shape=None, runs=None):
    """Returns (fn, example_args, meta) ready for ``hlo_cost.analyze(fn, *args)``
    (``cfg`` / ``microbatches`` / ``grad_shardings``: ``launch/perf``'s variant
    overrides; ``mesh_shape``: a smaller (data, model) or (pod, data,
    model) mesh in place of the production one, for tests; ``runs``: a
    train step of only the first ``runs`` of the cell's microbatches, each
    of the cell's size)."""
    cfg = cfg or get_config(arch)
    shape = S.SHAPES[shape_name]
    ok, why = S.cell_applicable(cfg, shape)
    if not ok:
        return None, None, {"skip": why}
    dev = resolve_device(device)
    mesh = _mesh(multi_pod, mesh_shape)
    batch_axes = S._batch_axes(mesh)
    opt = adamw(moment_dtype=_moment_dtype(cfg))
    sched = warmup_cosine(3e-4, 2000, 100_000)
    params = S.params_spec_tree(cfg, mesh, device=dev)
    meta = {"mesh_shape": S.mesh_sizes(mesh), "params": int(cfg.param_count()), "layout": "2d"}

    if shape.kind == "train":
        micro = microbatches or num_microbatches_for(cfg, shape, mesh)
        meta["num_microbatches"] = micro
        model = S.param_tree_module(params, mesh)
        opt_state = S.opt_state_spec_tree(opt.init, model, mesh)
        batch = S.batch_specs(cfg, shape, mesh, device=dev)
        meta["reference_argument_bytes"] = _local_bytes((model, opt_state, batch))
        state = TrainState(step=0, model=model, opt_state=opt_state, seed=0)
        # the 2-D step on the rank's blocks of the specs' fake tensors
        with S.fake_mode():
            state = fsdp_tp.place_train_state(state, mesh)
        grad_sh = [p.placement for p in state.model.parameters()] if grad_shardings else None
        block = _rank_block(batch, batch_axes, mesh)
        if runs is not None:
            block = _first_rows(block, runs, micro)
        step = make_train_step(cfg, opt, sched, num_microbatches=runs or micro, grad_shardings=grad_sh)
        return step, (state, block), meta

    # the 2-D serving steps on the rank's blocks of the parameters and of
    # the decode state, the slots over the batch axes
    caches = S.cache_specs(cfg, shape.global_batch, shape.seq_len, mesh, device=dev)
    with S.fake_mode():
        step_params, local_caches = fsdp_tp.place_params(params, mesh), fsdp_tp.place_caches(caches, cfg, mesh)

    if shape.kind == "prefill":
        toks = S.batch_specs(cfg, shape, mesh, device=dev)
        toks.pop("labels")
        meta["reference_argument_bytes"] = _local_bytes((params, caches, toks))
        prefill = make_prefill_step(cfg)

        @torch.no_grad()
        def fn(params, caches, inputs):
            return prefill(params, caches, **inputs)

        return fn, (step_params, local_caches, _rank_block(toks, batch_axes, mesh)), meta

    # decode: one new token against a seq_len cache, at the reference's
    # scalar position, a tensor whose value the host never reads (each
    # rank's write of the new row is masked on the device)
    toks = S.decode_token_specs(cfg, shape.global_batch, mesh, device=dev)
    cache_len = S.scalar_spec(mesh, device=dev)
    meta["reference_argument_bytes"] = _local_bytes((params, caches, cache_len, toks))
    decode = make_decode_step(cfg)

    @torch.no_grad()
    def fn(params, caches, cache_len, inputs):
        return decode(params, caches, cache_len, **inputs)

    return fn, (step_params, local_caches, cache_len, _rank_block(toks, batch_axes, mesh)), meta


# a train step of more microbatches is analysed at 3 and 4 of them and
# extended by the rest (``analyze_cell``)
MAX_ANALYSED_MICROBATCHES = 4


def analyze_cell(fn, args, meta, rebuild) -> hlo_cost.OpAnalysis:
    """The analysis of a cell that ``build_cell`` built as (``fn``, ``args``,
    ``meta``); ``rebuild(runs)`` builds it again with its ``runs`` argument.
    From a train step's third microbatch on, each microbatch dispatches
    the ops of the one before, takes as many batch bytes and raises the
    high-water mark by its metrics alone (the first starts the sums, and
    from the third on the loop holds the previous microbatch's gradients
    while it computes), so a train cell of k > MAX_ANALYSED_MICROBATCHES
    microbatches is analysed at 3 and 4 of them and extended by k - 4
    (``hlo_cost.extend``): the whole step's analysis, k / 7 times sooner."""
    micro = meta.get("num_microbatches", 1)
    if micro <= MAX_ANALYSED_MICROBATCHES:
        return hlo_cost.analyze(fn, *args)
    del fn, args
    parts = []
    for runs in (3, 4):
        fn, args, _ = rebuild(runs)
        parts.append(hlo_cost.analyze(fn, *args))
        del fn, args
    return hlo_cost.extend(*parts, micro - 4)


def model_flops(cfg, shape: S.ShapeSpec) -> float:
    """6*N_active*tokens (train) / 2*N_active*tokens (inference)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token per row


def record_analysis(rec: Dict, analysis: hlo_cost.OpAnalysis) -> None:
    """The analysis fields of a cell's record (shared with ``launch/perf``)."""
    rec["memory"] = {
        "argument_bytes": int(analysis.argument_bytes),
        "output_bytes": int(analysis.output_bytes),
        "temp_bytes": int(analysis.temp_bytes),
        "alias_bytes": int(analysis.alias_bytes),
    }
    rec["flops"] = analysis.flops  # per rank, every loop trip dispatched
    rec["hbm_bytes"] = analysis.hbm_bytes
    rec["collectives"] = {k: float(v) for k, v in analysis.collective_bytes.items()}
    rec["collectives"]["total"] = float(analysis.total_collective_bytes)
    rec["trip_counts"] = analysis.trip_counts
    rec["roofline"] = hlo_cost.roofline_terms(analysis)
    rec["kernel_launches"] = dict(analysis.kernel_launches)
    rec["flops_by_dtype"] = dict(analysis.flops_by_dtype)
    rec["fits_80gb"] = bool(analysis.peak_bytes <= HBM_BYTES)


def run_cell(arch: str, shape_name: str, multi_pod: bool, device=None, *, cfg=None, mesh_shape=None) -> Dict:
    """One cell's record (``cfg`` / ``mesh_shape``: see ``build_cell``)."""
    rec: Dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "pod2x16x16" if multi_pod else "pod16x16",
        "n_devices": 512 if multi_pod else 256,
    }
    if mesh_shape is not None:
        rec.update(mesh="pod" + "x".join(map(str, mesh_shape)), n_devices=math.prod(mesh_shape))
    try:
        t0 = time.time()
        cfg = cfg or get_config(arch)
        kw = dict(device=device, cfg=cfg, mesh_shape=mesh_shape)
        fn, args, meta = build_cell(arch, shape_name, multi_pod, **kw)
        if fn is None:
            rec.update(status="skipped", reason=meta["skip"])
            return rec
        rec.update(meta)
        # building the inputs stands where the reference lowers, the
        # analysis where it compiles
        rec["lower_s"] = round(time.time() - t0, 2)
        t0 = time.time()
        analysis = analyze_cell(fn, args, meta, lambda runs: build_cell(arch, shape_name, multi_pod, runs=runs, **kw))
        rec["compile_s"] = round(time.time() - t0, 2)
        record_analysis(rec, analysis)
        # eager runs every loop trip: the "body once" figures are the totals
        rec["cost_flops_body_once"] = analysis.flops
        rec["cost_bytes_body_once"] = analysis.hbm_bytes
        # no HLO: the number of ops the call dispatched stands in
        rec["hlo_lines"] = analysis.n_ops
        n_dev = rec["n_devices"]
        rec["model_flops_total"] = model_flops(cfg, S.SHAPES[shape_name])
        rec["model_flops_per_device"] = rec["model_flops_total"] / n_dev
        rec["useful_flops_ratio"] = (
            rec["model_flops_per_device"] / analysis.flops if analysis.flops else 0.0
        )
        rec["status"] = "ok"
    except Exception as e:  # recorded, not raised — the sweep continues
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(S.SHAPES) + [None])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="directory for per-cell JSON records")
    ap.add_argument("--device", default=None, help="'cuda' (default: the kernel route) or 'cpu' (the plain route)")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(S.SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    if args.out:
        os.makedirs(args.out, exist_ok=True)

    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                mesh_name = "multi" if multi else "single"
                out_path = (
                    os.path.join(args.out, f"{arch}__{shape}__{mesh_name}.json")
                    if args.out
                    else None
                )
                if out_path and os.path.exists(out_path):
                    print(f"[cached] {arch} {shape} {mesh_name}")
                    continue
                rec = run_cell(arch, shape, multi, device=args.device)
                keys = ("arch", "shape", "mesh", "status", "lower_s", "compile_s", "flops", "error")
                line = {k: rec.get(k) for k in keys}
                print(json.dumps(line), flush=True)
                if rec.get("status") == "ok":
                    print("  memory:", rec["memory"], " reference layout:", rec["reference_argument_bytes"],
                          " fits 80 GB:", rec["fits_80gb"])
                    print("  collectives:", {k: f"{v:.3g}" for k, v in rec["collectives"].items()})
                    roof = {k: (f"{v:.3g}" if isinstance(v, float) else v) for k, v in rec["roofline"].items()}
                    print("  roofline:", roof, " kernels:", rec["kernel_launches"])
                if out_path:
                    with open(out_path, "w") as f:
                        json.dump(rec, f, indent=1)
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
