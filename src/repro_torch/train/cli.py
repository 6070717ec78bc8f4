"""SSL pretraining CLI of the port: the twin of ``examples/ssl_pretrain.py``,
with checkpoint / restart, the preemption flag and the straggler watchdog.

    PYTHONPATH=src python -m repro_torch.train.cli --tiny --device cpu
    PYTHONPATH=src python -m repro_torch.train.cli --steps 300 --ckpt-dir /tmp/ssl_ckpt
    # kill it mid-run and rerun: it resumes from the newest checkpoint
    # distributed: one process a rank, the decorr engine's mode over a
    # (data, model) mesh of every rank
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.train.cli \
        --tiny --distributed tp --model-parallel 2 --device cpu

Without ``--device`` it runs on the card (the R_sum regularizer through the
hand-written kernels, forward and backward) and raises where CUDA is absent.
``--distributed`` runs ``make_sharded_ssl_train_step`` on every rank of the
process group: torchrun's world (gloo for ``--device cpu``, NCCL on
``cuda:LOCAL_RANK``), or a group of one without torchrun's environment.
Only rank 0 logs and writes checkpoints; a checkpoint holds the full tree
(the ``tp`` output layer gathered), the tree an unsharded run writes, and a
rerun on the same layout resumes from it.  ``--pretune`` (default
``analytic``; ``dry``, ``measure`` on the run's device, or ``off``) warms the
``repro_torch.tune`` choices of the shard-local regularizer shapes before
the first step (``decorr.warmup_tune_cache``).  ``--metrics-port`` /
``--alerts`` turn the telemetry on (``launch/obs_args``, rank 0): the
loop's histograms and gauges, a ``DecorrHealthMonitor`` on the projector
output of view 1 (the matrix the objective decorrelates), the train step's
roofline join (``attach_train_step``), one scrape at the end.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core.losses import normalized_bt_regularizer
from repro_torch.data.synthetic import SSLDataConfig, ssl_batch
from repro_torch.decorr import warmup_tune_cache
from repro_torch.decorr.config import DecorrConfig
from repro_torch.launch.mesh import make_mesh_for_devices
from repro_torch.launch.obs_args import add_obs_args, attach_train_step, build_train_obs, finish_train_obs
from repro_torch.optim.optimizers import lars, warmup_cosine
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.ssl import (
    SSLModelConfig,
    create_sharded_ssl_state,
    init_ssl_model,
    make_sharded_ssl_train_step,
    make_ssl_train_step,
    shard_ssl_batch,
    ssl_param_specs,
)
from repro_torch.train.train_state import create_train_state


def _args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.train.cli", description=__doc__.split("\n")[0])
    ap.add_argument("--tiny", action="store_true", help="256 -> 128 -> 256 -> 256, batch 128, at most 120 steps")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--d", type=int, default=8192, help="projector width (paper: 8192)")
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--reg", default="sum", choices=["sum", "off"])
    ap.add_argument("--no-permute", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--preempt-flag", default=None)
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    ap.add_argument("--distributed", default=None, choices=["local", "global", "tp"],
                    help="run the sharded step on every rank of the process group in this decorr "
                         "engine mode (default: the single-device step)")
    ap.add_argument("--model-parallel", type=int, default=1, help="model-axis size for --distributed tp")
    add_obs_args(ap)
    ap.add_argument("--pretune", default="analytic", choices=["off", "analytic", "dry", "measure"],
                    help="warm the repro_torch.tune choices of the shard-local regularizer shapes first")
    return ap.parse_args(argv)


def _init_process_group(dev: torch.device) -> bool:
    """Join torchrun's world (its environment) or make a group of one; gloo
    on the CPU, NCCL on a card.  False when a group already exists (the
    caller's, left as it is)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Train, log, checkpoint; print Eq. 16 at the end.  Returns 0."""
    args = _args(argv)
    dev = resolve_device(args.device)
    if args.distributed is None:
        return _train(args, dev, None)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    owns_group = _init_process_group(dev)
    try:
        return _train(args, dev, make_mesh_for_devices(dist.get_world_size(), args.model_parallel))
    finally:
        if owns_group:
            dist.destroy_process_group()


def _train(args: argparse.Namespace, dev: torch.device, mesh) -> int:
    rank = dist.get_rank() if mesh is not None else 0
    if mesh is not None and dist.get_world_size() > 1 and args.preempt_flag:
        raise ValueError("--preempt-flag with more than one rank: each rank would read the flag "
                         "at its own time and stop at its own step")
    say = print if rank == 0 else (lambda *a, **k: None)

    if args.tiny:
        model_cfg = SSLModelConfig(input_dim=256, backbone_widths=(128,), projector_widths=(256, 256))
        data = SSLDataConfig(input_dim=256, batch=128)
        args.steps = min(args.steps, 120)
    else:
        # ~100M params: 3072 -> 4096 -> 4096 backbone, d-wide projector
        model_cfg = SSLModelConfig(input_dim=3072, backbone_widths=(4096, 4096), projector_widths=(args.d, args.d))
        data = SSLDataConfig(input_dim=3072, batch=args.batch)

    model = init_ssl_model(model_cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[ssl_pretrain] ~{n_params / 1e6:.1f}M params, d={model.d}, batch={data.batch}, "
        f"reg={args.reg}, permute={not args.no_permute}, device={dev}", flush=True)

    loss_cfg = DecorrConfig(
        style="bt", reg=args.reg, q=2,
        block_size=args.block_size if args.reg == "sum" else None,
        lam=2.0**-10, permute=not args.no_permute,
        distributed=args.distributed or "local",
    )
    opt = lars(weight_decay=1e-4)  # the paper's optimizer
    sched = warmup_cosine(0.2, max(args.steps // 10, 1), args.steps)
    if mesh is None:
        state = create_train_state(model, opt)
        step_fn, _ = make_ssl_train_step(model_cfg, loss_cfg, opt, sched)
    else:
        say(f"[ssl_pretrain] mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} mode={args.distributed}", flush=True)
        state = create_sharded_ssl_state(model, opt, ssl_param_specs(model_cfg, loss_cfg, mesh), mesh)
        step_fn, _ = make_sharded_ssl_train_step(model_cfg, loss_cfg, opt, sched, mesh)

    if args.pretune != "off":
        # warm the tuned choices for the SHARD-LOCAL shapes, so no search
        # lands inside the first step
        t_tune = time.time()
        n_jobs = len(warmup_tune_cache(data.batch, model_cfg.projector_widths[-1], loss_cfg, mesh=mesh,
                                       mode=args.pretune, device=dev))
        say(f"[ssl_pretrain] pre-tuned {n_jobs} kernel shapes ({args.pretune}, {time.time() - t_tune:.1f}s)",
            flush=True)

    def batch_fn(step):
        v1, v2 = ssl_batch(data, step)
        batch = {"view1": torch.from_numpy(v1).to(dev), "view2": torch.from_numpy(v2).to(dev)}
        return batch if mesh is None else shard_ssl_batch(batch, mesh)

    t0 = time.time()

    def log_fn(step, m):
        loss_key = next(k for k in m if k.endswith("loss"))
        print(f"  step {step:5d}  loss={m[loss_key]:10.4f}  "
              f"({time.time() - t0:6.1f}s, stragglers={m.get('stragglers', 0)})", flush=True)

    lcfg = LoopConfig(
        total_steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_interval=max(args.steps // 6, 10),
        log_interval=max(args.steps // 15, 1),
        preempt_flag=args.preempt_flag,
        ckpt_writer=rank == 0,
    )
    obs = build_train_obs(args) if rank == 0 else None
    monitor = None
    if obs is not None:
        from repro_torch.obs import DecorrHealthMonitor

        # probe the projector output of view1 — the matrix the decorrelation
        # objective acts on — for collapse / relaxation-gap health
        monitor = DecorrHealthMonitor(lambda m, batch: m(batch["view1"]), device=dev)
        attach_train_step(obs, step_fn, state, batch_fn(0))
    state = run_training(
        state, step_fn, batch_fn, lcfg, log_fn=log_fn if rank == 0 else None,
        registry=obs.registry if obs is not None else None,
        monitor=monitor,
        perf=obs.perf if obs is not None else None,
    )
    finish_train_obs(args, obs)

    if mesh is not None:
        model.load_state_dict(state.state_dict()["params"])  # the full tree, gathered on every rank
    v1, v2 = ssl_batch(data, 10_000)
    with torch.no_grad():
        q16 = normalized_bt_regularizer(model(torch.from_numpy(v1).to(dev)), model(torch.from_numpy(v2).to(dev)))
    say(f"[ssl_pretrain] final step={state.step}  normalized R_off (Eq.16) = {float(q16):.4f}  "
        f"total {time.time() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
