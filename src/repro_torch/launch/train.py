"""LM training launcher (port of ``repro/launch/train.py``, single device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --reduced \
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --device cpu

Without ``--device cpu`` it runs on the card and raises where CUDA is
absent.  ``--decorr`` turns on the paper's aux loss (VICReg-style R_sum,
q = 2, on the final hidden states; ``--decorr-block`` groups it), whose R
runs the hand-written kernels forward and backward on the card.  A rerun
with the same ``--ckpt-dir`` resumes from the newest checkpoint.
With ``--decorr``, ``--pretune`` (default ``analytic``; ``dry``, ``measure``
on ``--device``, or ``off``) warms the ``repro_torch.tune`` choices of the
aux loss's shapes (batch * tokens_per_seq rows of width d_model) before the
first step (``decorr.warmup_tune_cache``).
``--metrics-port`` / ``--alerts`` turn the telemetry on (``launch/obs_args``):
per-phase histograms, ``train_*`` gauges, the step's device-inclusive
time and its roofline join (``attach_train_step``), scraped once over HTTP
at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.decorrelation import LMDecorrConfig
from repro_torch.data.synthetic import LMDataConfig, lm_batch
from repro_torch.launch.obs_args import add_obs_args, attach_train_step, build_train_obs, finish_train_obs
from repro_torch.decorr.config import DecorrConfig
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import ParamTree, init_params
from repro_torch.optim.optimizers import adamw, warmup_cosine
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.step import make_train_step
from repro_torch.train.train_state import TrainState, create_train_state

Tensor = torch.Tensor


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The reference launcher's flags, plus ``--device``."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train", description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--decorr", action="store_true", help="enable the paper's aux loss")
    ap.add_argument("--decorr-block", type=int, default=None)
    ap.add_argument("--pretune", default="analytic", choices=["off", "analytic", "dry", "measure"],
                    help="warm the repro_torch.tune choices of the aux loss's shapes before the first step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    add_obs_args(ap)
    return ap.parse_args(argv)


def lm_batch_fn(cfg: ArchConfig, data: LMDataConfig, device) -> Callable[[int], Dict[str, Tensor]]:
    """``batch_fn(step)``: ``lm_batch`` on ``device``.  A ``vision_stub``
    arch gets pseudo patch embeddings instead of tokens (normal * 0.02 from
    a ``torch.Generator`` seeded from (seed, step)) and (3, B, S) M-RoPE
    positions, every stream 0..S-1."""

    def batch_fn(step: int) -> Dict[str, Tensor]:
        out = {k: torch.from_numpy(v).to(device) for k, v in lm_batch(data, step).items()}
        if cfg.frontend == "vision_stub":
            tok = out.pop("tokens")
            gen = torch.Generator(device="cpu").manual_seed(data.seed * 1_000_003 + step)
            out["embeds"] = (torch.randn((*tok.shape, cfg.d_model), generator=gen) * 0.02).to(device)
            pos = torch.arange(tok.shape[1], dtype=torch.int64, device=device)[None, None, :]
            out["positions"] = pos.expand(3, *tok.shape)
        return out

    return batch_fn


def train(args: argparse.Namespace) -> TrainState:
    """Build the arch, its AdamW state and step; run (resuming from
    ``--ckpt-dir``); returns the final state."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.decorr:
        cfg = dataclasses.replace(
            cfg,
            decorr=LMDecorrConfig(
                enabled=True,
                decorr=DecorrConfig(style="vic", reg="sum", block_size=args.decorr_block, q=2),
                nu=0.04,
            ),
        )
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[train] arch={cfg.name} params~{cfg.param_count() / 1e6:.1f}M device={name}", flush=True)
    if args.decorr and args.pretune != "off":
        from repro_torch.decorr import warmup_tune_cache

        # the aux-loss statistic has batch * tokens_per_seq rows of width
        # d_model: pre-tune those shapes so no search lands in the first step
        t_tune = time.time()
        n_jobs = len(warmup_tune_cache(args.batch * cfg.decorr.tokens_per_seq, cfg.d_model, cfg.decorr.decorr,
                                       mode=args.pretune, device=dev))
        print(f"[train] pre-tuned {n_jobs} decorr kernel shapes ({args.pretune}, {time.time() - t_tune:.1f}s)",
              flush=True)
    model = ParamTree(init_params(cfg, seed=args.seed, device=dev))
    opt = adamw()
    sched = warmup_cosine(args.lr, max(args.steps // 10, 1), args.steps)
    state = create_train_state(model, opt, seed=args.seed)
    step_fn = make_train_step(cfg, opt, sched, num_microbatches=args.microbatches)
    data = LMDataConfig(
        vocab_size=cfg.vocab_size,
        batch=args.batch,
        seq_len=args.seq,
        seed=args.seed,
        n_codebooks=cfg.n_codebooks if cfg.frontend == "audio_codes" else 0,
    )
    lcfg = LoopConfig(
        total_steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_interval=args.ckpt_interval,
        log_interval=max(args.steps // 10, 1),
    )
    t0 = time.time()

    def log_fn(step, m):
        print(f"  step {step:5d} loss={m.get('loss', 0):.4f} ce={m.get('ce', 0):.4f} "
              f"decorr={m.get('decorr_aux', 0):.5f} ({time.time() - t0:.1f}s)", flush=True)

    obs = build_train_obs(args)
    batch_fn = lm_batch_fn(cfg, data, dev)
    if obs is not None:
        # the step's roofline join, analysed on fake copies (nothing runs)
        attach_train_step(obs, step_fn, state, batch_fn(0))
    state = run_training(
        state, step_fn, batch_fn, lcfg, log_fn=log_fn,
        registry=obs.registry if obs is not None else None,
        perf=obs.perf if obs is not None else None,
    )
    print(f"[train] done at step {state.step} in {time.time() - t0:.1f}s", flush=True)
    finish_train_obs(args, obs)
    return state


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry: train; returns 0."""
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
