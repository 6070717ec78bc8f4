"""Driver of the SSL training cells: ``repro_torch.train.ssl.make_ssl_train_step``.

The window calls the system's ``train_step(state, batch)`` on a pool of
two-view batches made on the device from the seed: the backbone and
projector forward on both views, ``core/losses.ssl_loss`` (the regularizer
on the kernel route on a CUDA device), the backward through the kernels'
vjps, and the optimizer's update.  The step's feature permutation is the
system's own (``permutation_for_step(seed, step, d)``).

Set-up builds the model on the device with the weights the benchmark made,
the optimizer and the step, and drives the first ``follow_steps`` steps
through that same step, reading the losses, the first gradient as the
optimizer takes it, and each leaf's change after them.  The
reference (``bench/reference/ssl.py``) follows the same steps after the
window.

The traced run also times ``ssl_loss``'s forward and backward alone on the
cell's own projections (CUDA events over many calls), for the loss's
roofline share.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from bench.benchlib import gen
from bench.counts import ssl as ssl_counts
from bench.reference import optim as ref_optim
from bench.reference import ssl as ref_ssl

LOSS_KEY = {"bt": "bt_loss", "vic": "vic_loss"}
LOSS_CALLS = 50


def _first_gradient_norms(opt, names) -> Dict[str, float]:
    """By leaf (``names`` in the optimizer's parameter order), the norm of
    the gradient that the optimizer takes at its next step, filled in by
    that step.  LARS's state cannot give it: its momentum after one step is
    the trust-scaled gradient, whose norm on a matrix is about tc |p| for
    any gradient.  So the optimizer's ``step`` is wrapped for that one call,
    and from then on its class's own ``step`` runs unwrapped."""
    taken: Dict[str, float] = {}

    def step(lr, grads):
        del opt.step
        taken.update(zip(names, (float(torch.linalg.vector_norm(g.float())) for g in grads)))
        return type(opt).step(opt, lr, grads)

    opt.step = step
    return taken


class Session:
    """The system's step, its state and the batch pool of one run."""

    def __init__(self, c, seed: int, device):
        from repro_torch.decorr.config import DecorrConfig
        from repro_torch.optim import optimizers as port_optim
        from repro_torch.train import ssl as port_ssl
        from repro_torch.train.train_state import create_train_state

        t_build = time.perf_counter()
        cfg, tr = c.config, c.traffic
        if cfg.get("dtype", "float32") != "float32":
            raise ValueError("the SSL driver runs float32 configurations")
        # float32 as the configuration states it: no TF32 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.tr, self.seed, self.device = cfg, tr, seed, device
        self.model_cfg = port_ssl.SSLModelConfig(
            input_dim=cfg["input_dim"], backbone_widths=tuple(cfg["backbone_widths"]),
            projector_widths=tuple(cfg["projector_widths"]))
        with torch.device(device):
            model = port_ssl.SSLModel(self.model_cfg)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(gen.ssl_leaf(cfg, seed, name, tuple(p.shape), device))
        opt = getattr(port_optim, tr["optimizer"]["name"])(**tr["optimizer"]["hyper"])
        sched = port_optim.warmup_cosine(**tr["schedule"])
        self.loss_cfg = DecorrConfig(**tr["loss"])
        self.state = create_train_state(model, opt, seed=seed)
        self.train_step, _ = port_ssl.make_ssl_train_step(self.model_cfg, self.loss_cfg, opt, sched,
                                                          clip_norm=tr.get("clip_norm"))
        self.pool = [gen.ssl_batch(tr, cfg["input_dim"], seed, i, device) for i in range(int(tr["pool"]))]
        self.key = LOSS_KEY[self.loss_cfg.style]
        self.k = 0
        self.bad = torch.zeros((), dtype=torch.int64, device=device)
        batch = int(tr["batch"])
        self.work = {"samples": batch}
        self.counts = {"model_flops_per_step": ssl_counts.step_flops(cfg, batch)}
        self.phases = {"built_s": time.perf_counter() - t_build}
        follow = int(tr.get("follow_steps", 3))
        if follow > len(self.pool):
            raise ValueError(f"the first {follow} steps need as many distinct batches; the pool has {len(self.pool)}")
        self.readings = self._first_steps(follow)
        self.phases["first_steps_s"] = time.perf_counter() - t_build - self.phases["built_s"]
        self.bad.zero_()

    def step(self):
        """One timed call: the system's step on the pool's next batch."""
        self.state, m = self.train_step(self.state, self.pool[self.k % len(self.pool)])
        self.k += 1
        self.bad += ~torch.isfinite(m[self.key])
        return m

    def _first_steps(self, n: int) -> Dict:
        params = dict(self.state.model.named_parameters())
        opt = self.state.opt_state
        taken = _first_gradient_norms(opt, list(params))
        losses = []
        for _ in range(n):
            m = self.step()
            losses.append(float(m[self.key]))
        # a step that never reached the optimizer gave it no gradient: norm 0
        vars(opt).pop("step", None)
        first = {name: taken.get(name, 0.0) for name in params}
        with torch.no_grad():
            changes = {name: float(torch.linalg.vector_norm(
                p - gen.ssl_leaf(self.cfg, self.seed, name, tuple(p.shape), self.device)))
                for name, p in params.items()}
        return {"losses": losses, "first_grads": first, "changes": changes}

    def failed(self) -> int:
        """Timed steps whose loss was not finite."""
        return int(self.bad)

    def probe(self, sync) -> Dict:
        """The loss's forward and backward alone, on the cell's own projections."""
        from repro_torch.core.losses import ssl_loss
        from repro_torch.core.permutation import permutation_for_step

        model = self.state.model
        batch = self.pool[0]
        with torch.no_grad():
            z1, z2 = model(batch["view1"]), model(batch["view2"])
        z1.requires_grad_(True)
        z2.requires_grad_(True)
        perm = permutation_for_step(self.seed, 0, z1.shape[1], device=self.device)

        def once():
            loss, _ = ssl_loss(z1, z2, self.loss_cfg, perm)
            torch.autograd.grad(loss, (z1, z2))

        for _ in range(3):
            once()
        sync()
        if self.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(LOSS_CALLS):
                once()
            end.record()
            sync()
            seconds = start.elapsed_time(end) * 1e-3 / LOSS_CALLS
        else:
            t0 = time.perf_counter()
            for _ in range(LOSS_CALLS):
                once()
            seconds = (time.perf_counter() - t0) / LOSS_CALLS
        return {"loss_time_s": seconds, "loss_shape": list(z1.shape), "loss": self.tr["loss"]}

    def close(self):
        self.state = self.train_step = self.pool = None


def setup(c, seed: int, device) -> Session:
    """The system's step, driven through its first steps (see the module note)."""
    return Session(c, seed, device)


def reference(c, seed: int, device, precision: str = "fp32") -> Dict:
    """The plain reference's readings of the same first steps."""
    cfg, tr = c.config, c.traffic
    n = int(tr.get("follow_steps", 3))
    d = cfg["projector_widths"][-1]
    params = {name: gen.ssl_leaf(cfg, seed, name, shape, device) for name, shape in gen.ssl_leaves(cfg)}
    batches = [gen.ssl_batch(tr, cfg["input_dim"], seed, i, device) for i in range(n)]
    perms = [ref_optim.permutation(seed, s, d, device) for s in range(n)]
    opt = (tr["optimizer"]["name"], tr["optimizer"]["hyper"])
    return ref_ssl.follow(params, len(cfg["backbone_widths"]), batches, perms, tr["loss"], opt,
                          ref_optim.warmup_cosine(**tr["schedule"]), precision)
