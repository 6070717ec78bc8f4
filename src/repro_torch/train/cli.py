"""SSL pretraining CLI of the port: the twin of ``examples/ssl_pretrain.py``,
single device, with checkpoint / restart, the preemption flag and the
straggler watchdog.

    PYTHONPATH=src python -m repro_torch.train.cli --tiny --device cpu
    PYTHONPATH=src python -m repro_torch.train.cli --steps 300 --ckpt-dir /tmp/ssl_ckpt
    # kill it mid-run and rerun: it resumes from the newest checkpoint

Without ``--device`` it runs on the card (the R_sum regularizer through the
hand-written kernels, forward and backward) and raises where CUDA is absent.
``--distributed`` and ``--pretune`` belong to later slices of the port and
raise.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core.losses import normalized_bt_regularizer
from repro_torch.data.synthetic import SSLDataConfig, ssl_batch
from repro_torch.decorr.config import DecorrConfig
from repro_torch.optim.optimizers import lars, warmup_cosine
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.ssl import SSLModelConfig, init_ssl_model, make_ssl_train_step
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
                    help="not ported yet (the distributed decorrelation slice)")
    ap.add_argument("--pretune", default=None, choices=["off", "analytic", "dry", "measure"],
                    help="not ported yet (the tuning slice)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Train, log, checkpoint; print Eq. 16 at the end.  Returns 0."""
    args = _args(argv)
    if args.distributed is not None:
        raise NotImplementedError(
            "--distributed needs the distributed decorrelation slice of the port "
            "(torch.distributed global / tp modes), which is not ported yet"
        )
    if args.pretune not in (None, "off"):
        raise NotImplementedError(
            "--pretune needs the tuning slice of the port (the Hopper kernel tuner), which is not ported yet"
        )
    dev = resolve_device(args.device)

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
    print(f"[ssl_pretrain] ~{n_params / 1e6:.1f}M params, d={model.d}, batch={data.batch}, "
          f"reg={args.reg}, permute={not args.no_permute}, device={dev}", flush=True)

    loss_cfg = DecorrConfig(
        style="bt", reg=args.reg, q=2,
        block_size=args.block_size if args.reg == "sum" else None,
        lam=2.0**-10, permute=not args.no_permute,
    )
    opt = lars(weight_decay=1e-4)  # the paper's optimizer
    state = create_train_state(model, opt)
    sched = warmup_cosine(0.2, max(args.steps // 10, 1), args.steps)
    step_fn, _ = make_ssl_train_step(model_cfg, loss_cfg, opt, sched)

    def batch_fn(step):
        v1, v2 = ssl_batch(data, step)
        return {"view1": torch.from_numpy(v1).to(dev), "view2": torch.from_numpy(v2).to(dev)}

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
    )
    state = run_training(state, step_fn, batch_fn, lcfg, log_fn=log_fn)

    v1, v2 = batch_fn(10_000).values()
    with torch.no_grad():
        q16 = normalized_bt_regularizer(model(v1), model(v2))
    print(f"[ssl_pretrain] final step={state.step}  normalized R_off (Eq.16) = {float(q16):.4f}  "
          f"total {time.time() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
