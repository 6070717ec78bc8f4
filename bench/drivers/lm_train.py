"""Driver of the LM training cells: ``repro_torch.train.step.make_train_step``.

The window calls the system's ``train_step(state, batch)`` on a pool of
token batches made on the device from the seed: ``models/transformer.forward``
(rematerialised per layer as the configuration states), the mean
cross-entropy, the paper's auxiliary loss on the final hidden states
through ``core/decorrelation`` and the regularizer's kernels, the backward
pass, the global-norm clip and AdamW.  The aux's feature permutation is
the system's own (``permutation_for_step(seed, step, d_model)``).

Set-up builds the architecture from the configuration's file (every size
it lists replaces the system's own config of that arch), the parameters
from the benchmark's leaves, the optimizer and the step, and drives the
first ``follow_steps`` steps through that same step; the reference
(``bench/reference/rwkv6.py``) follows them after the window, in float32.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import torch

from bench.benchlib import gen
from bench.counts import lm as lm_counts
from bench.reference import optim as ref_optim
from bench.reference import rwkv6 as ref_rwkv6

# the configuration file's keys that are sizes or settings of the arch
ARCH_KEYS = ("n_layers", "d_model", "d_ff", "vocab_size", "rwkv_head_dim", "rwkv_chunk", "rms_eps", "remat",
             "remat_policy")
DTYPE_KEYS = ("param_dtype", "compute_dtype", "optimizer_moment_dtype")


def arch_config(cfg: Dict, traffic: Dict):
    """The system's ``ArchConfig`` for the configuration and the mix's aux loss."""
    from repro_torch.configs import get_config
    from repro_torch.core.decorrelation import LMDecorrConfig
    from repro_torch.decorr.config import DecorrConfig

    aux = dict(traffic["aux"])
    decorr = DecorrConfig(**{k: aux.pop(k) for k in ("style", "reg", "block_size", "q", "permute") if k in aux})
    sizes = {k: cfg[k] for k in ARCH_KEYS if k in cfg}
    sizes.update({k: getattr(torch, cfg[k]) for k in DTYPE_KEYS if k in cfg})
    return dataclasses.replace(get_config(cfg["arch"]), **sizes,
                               decorr=LMDecorrConfig(enabled=True, decorr=decorr, **aux))


class Session:
    """The system's step, its state and the batch pool of one run."""

    def __init__(self, c, seed: int, device):
        from repro_torch.models.transformer import ParamTree, param_shapes
        from repro_torch.optim import optimizers as port_optim
        from repro_torch.train.step import make_train_step
        from repro_torch.train.train_state import create_train_state

        t_build = time.perf_counter()
        cfg, tr = c.config, c.traffic
        self.cfg, self.tr, self.seed, self.device = cfg, tr, seed, device
        arch = arch_config(cfg, tr)
        shapes = ref_rwkv6.leaf_shapes(cfg)
        theirs = dict(_flat(param_shapes(arch)))
        if theirs != shapes:
            raise ValueError(f"the system's leaves {sorted(theirs.items())} are not the benchmark's "
                             f"{sorted(shapes.items())}")
        model = ParamTree(gen.nest(dict(gen.lm_leaves(cfg, shapes, seed, device))))
        opt = port_optim.adamw(**tr["optimizer"]["hyper"], moment_dtype=arch.optimizer_moment_dtype)
        sched = port_optim.warmup_cosine(**tr["schedule"])
        self.state = create_train_state(model, opt, seed=seed)
        self.train_step = make_train_step(arch, opt, sched, clip_norm=tr.get("clip_norm"))
        self.pool = gen.lm_batches(tr, cfg["vocab_size"], seed, range(int(tr["pool"])), device)
        self.k = 0
        self.bad = torch.zeros((), dtype=torch.int64, device=device)
        b, s = int(tr["batch"]), int(tr["seq"])
        self.work = {"tokens": b * s}
        self.counts = {"model_flops_per_step": lm_counts.step_flops(cfg, b, s)}
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
        self.bad += ~torch.isfinite(m["loss"])
        return m

    def _first_steps(self, n: int) -> Dict:
        params = dict(self.state.model.named_parameters())
        losses, first = [], None
        for i in range(n):
            m = self.step()
            losses.append(float(m["loss"]))
            if i == 0:
                opt = self.state.opt_state
                b1 = opt.param_groups[0]["b1"]
                first = {name: float(torch.linalg.vector_norm(opt.state[p]["m"].float())) / (1 - b1)
                         for name, p in params.items()}
        with torch.no_grad():
            changes = {name: float(torch.linalg.vector_norm(
                p.float() - gen.lm_leaf(self.cfg, self.seed, name, tuple(p.shape), self.device).float()))
                for name, p in params.items()}
        return {"losses": losses, "first_grads": first, "changes": changes}

    def failed(self) -> int:
        """Timed steps whose loss was not finite."""
        return int(self.bad)

    def probe(self, sync) -> Dict:
        return {}

    def close(self):
        self.state = self.train_step = self.pool = None


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tuple(v)


def setup(c, seed: int, device) -> Session:
    """The system's step, driven through its first steps (see the module note)."""
    return Session(c, seed, device)


def reference(c, seed: int, device, precision: str = "fp32") -> Dict:
    """The plain reference's readings of the same first steps, in float32
    from the same starting values."""
    cfg, tr = c.config, c.traffic
    n = int(tr.get("follow_steps", 3))
    shapes = ref_rwkv6.leaf_shapes(cfg)
    params = {name: leaf.float() for name, leaf in gen.lm_leaves(cfg, shapes, seed, device)}
    batches = gen.lm_batches(tr, cfg["vocab_size"], seed, range(n), device)
    aux = tr["aux"]
    perms = [ref_optim.permutation(seed, s, cfg["d_model"], device) if aux.get("permute", True) else None
             for s in range(n)]
    out = ref_rwkv6.follow(params, batches, perms, cfg, aux, ("adamw", tr["optimizer"]["hyper"]),
                           tr.get("clip_norm"), ref_optim.warmup_cosine(**tr["schedule"]), precision)
    with torch.no_grad():
        out["changes"] = {name: float(torch.linalg.vector_norm(
            params[name] - gen.lm_leaf(cfg, seed, name, shape, device).float()))
            for name, shape in shapes.items()}
    return out
