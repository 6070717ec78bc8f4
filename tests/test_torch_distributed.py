"""Distributed decorrelation and compressed data-parallel training of the
port, on the CPU.

One module fixture starts, all at once: two gloo jobs of the port (4 data
ranks on a (4, 1) mesh; a (2, 2) data x model mesh), one subprocess that
computes the reference's values on 4 fake XLA devices (meshes from
``repro.launch.mesh.make_mesh_for_devices``, whose ``Auto`` axes let the
reference's modes run forward under ``shard_map``), and the first of two
``torchrun`` runs of the training CLI.  Every input comes from a numpy
seed; permutations come from the reference's PRNG via numpy.

* Forward values against the reference's own sharded forward: ``r_sum_global``
  (q 1 / 2, ungrouped / b = 8), ``r_sum_tp``, ``r_off_global``,
  ``engine.apply`` (bt / vic x q x b) in ``global`` and ``tp``, the
  ``ddof`` scale under ``global``, VICReg ``global`` on global moments,
  ``bf16_psum`` and ``int8_psum_ef``.
* Gradients and steps against the single-device oracle on the whole batch
  (the reference's gradients through ``shard_map`` fail: ROADMAP queue 3):
  the input gradients of those functions gathered over the ranks (and the
  port's own single-device route); two AdamW steps (clip on) of
  ``make_sharded_ssl_train_step`` in ``global`` and ``tp`` against
  ``make_ssl_train_step`` on the concatenated batch, in ``local`` against
  the step on the mean of the per-shard gradients;
  ``make_compressed_dp_step`` (none / bf16 / int8_ef) against the same
  mean-gradient step; error feedback over 20 steps.
* The config guards and a trivial mesh in this process; the CLI under
  ``torchrun`` (4 ranks, ``tp``, model-parallel 2), run, then rerun to resume.

Tolerances are the reference's: losses and gradients 5e-4 relative (a
gradient leaf against its largest entry, or 1e-3 of the largest over all
leaves where it vanishes in exact arithmetic), int8 sums exact, bf16 sums
within one bf16 ulp of the largest entry (XLA and gloo add in different
orders).
"""

import functools
import inspect
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.decorr import DecorrConfig as RefConfig  # noqa: E402
from repro.decorr import engine as ref_engine  # noqa: E402
from repro.parallel import sharding as ref_sharding  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.core.losses import ssl_loss  # noqa: E402
from repro_torch.decorr import DecorrConfig, engine  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.optim import adamw, lars, warmup_cosine  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.train import create_train_state  # noqa: E402
from repro_torch.train.ssl import (  # noqa: E402
    SSLModelConfig,
    create_sharded_ssl_state,
    init_ssl_model,
    make_sharded_ssl_train_step,
    make_ssl_train_step,
    ssl_param_specs,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 5e-4
N, D = 32, 32
# the cases both sides compute; b = None is "ungrouped"
CASES = {
    "apply": [[s, q, b] for s in ("bt", "vic") for q in (1, 2) for b in (None, 8)],
    "rsum": [[q, b] for q in (1, 2) for b in (None, 8)],
    "rsum_tp": [[2, None], [1, 8]],
    "steps": {"bt-q2-b8": dict(style="bt", q=2, block_size=8), "vic-q1": dict(style="vic", q=1, block_size=None)},
    "widths": dict(input_dim=16, backbone_widths=[24], projector_widths=[32, 32]),
    "lr": 1e-3,
    "sgd_lr": 0.05,
}
# the vanishing leaf: the projector's last bias (standardized / centered away)
LAST_BIAS = "projector.1.bias"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (see tests/test_torch_lm_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tree_rel(got: dict, want: dict) -> dict:
    """Per-leaf error relative to the leaf's largest entry, or to 1e-3 of
    the largest over all leaves where the leaf nearly vanishes."""
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want.values())
    return {k: float(np.abs(np.asarray(got[k], np.float64) - want[k]).max() / max(float(np.abs(want[k]).max()), floor))
            for k in want}


def _ref_perm(seed, d=D, step=None):
    key = jax.random.PRNGKey(seed)
    if step is not None:
        key = jax.random.fold_in(key, step)
    return np.array(jax.random.permutation(key, d))


@functools.lru_cache(maxsize=None)
def _inputs() -> dict:
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    z1 = f32(N, D)
    z1[:, :16] += 0.7 * z1[:, 16:]  # correlated halves: R is far from 0
    zc = f32(64, 16)
    shift = np.repeat(np.arange(4.0), 16)[:, None].astype(np.float32) * 3.0
    w = CASES["widths"]
    dims = [w["input_dim"], *w["backbone_widths"], *w["projector_widths"]]
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        part, j = ("backbone", i) if i < len(w["backbone_widths"]) else ("projector", i - len(w["backbone_widths"]))
        params[f"{part}.{j}.w"] = (f32(a, b) / np.sqrt(a)).astype(np.float32)
        params[f"{part}.{j}.b"] = (0.1 * f32(b)).astype(np.float32)
    return dict(
        z1=z1, z2=(z1 + 0.5 * f32(N, D)).astype(np.float32), perm=_ref_perm(5), perm_seed=np.int64(5),
        zc=(zc - zc.mean(axis=0, keepdims=True)).astype(np.float32),
        zv1=(f32(64, 12) + shift).astype(np.float32), zv2=(f32(64, 12) + shift).astype(np.float32),
        v1=f32(N, 16), v2=f32(N, 16), perm_s0=_ref_perm(0, step=0), perm_s1=_ref_perm(0, step=1),
        g=f32(64, 16), cases=np.array(json.dumps(CASES)), **params,
    )


# ---------------------------------------------------------------------------
# the jobs: self-contained functions, each run as ``python -c`` of its source
# ---------------------------------------------------------------------------


def _port_job(rank, world, model_parallel, inputs, out, store):
    import datetime
    import json

    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, mp_ = int(rank), int(world), int(model_parallel)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    from repro_torch.core import distributed as cdist
    from repro_torch.decorr import DecorrConfig, engine
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.optim import adamw, compression, sgd_momentum, warmup_cosine
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import create_train_state, ssl
    from repro_torch.train.step import make_compressed_dp_step

    inp = dict(np.load(inputs))
    cases = json.loads(str(inp["cases"]))
    mesh = make_mesh_for_devices(world, mp_)
    tp = mp_ > 1
    T = lambda k: torch.from_numpy(inp[k])  # noqa: E731
    rows, cells = ("data", None), ("data", "model")
    res = {}

    def grads_of(fn, spec, *names):
        xs = [shd.NamedSharding(mesh, spec).local(T(k)).requires_grad_() for k in names]
        val = fn(*xs)
        gs = torch.autograd.grad(val, xs)
        return [val.detach().numpy()] + [shd.NamedSharding(mesh, spec).gather(g).numpy() for g in gs]

    def record(key, outs):
        res[key] = outs[0]
        for i, g in enumerate(outs[1:], 1):
            res[f"{key}/dz{i}"] = g

    with shd.sharding_context(mesh):
        for mode in ("global", "tp") if tp else ("global",):
            spec = cells if mode == "tp" else rows
            for style, q, b in cases["apply"]:
                cfg = DecorrConfig(style=style, q=q, block_size=b, distributed=mode, axis_name="data",
                                   model_axis="model" if mode == "tp" else None)
                # grouped: the plain route, and the kernel route's planes (the
                # kernels' plain versions here) as the card runs them
                for tag, impl in (("apply", None), ("applyk", "kernel")) if b else (("apply", None),):
                    record(f"{tag}/{mode}/{style}/q{q}/b{b}",
                           grads_of(lambda a, c: engine.apply(a, c, cfg, T("perm"), impl=impl)[0], spec, "z1", "z2"))
        if tp:
            for q, b in cases["rsum_tp"]:
                record(f"rsum_tp/q{q}/b{b}", grads_of(lambda a, c: cdist.r_sum_tp(
                    a, c, model_axis="model", batch_axis="data", q=q, block_size=b, scale=a.shape[0]),
                    cells, "z1", "z2"))
        else:
            for q, b in cases["rsum"]:
                record(f"rsum/q{q}/b{b}", grads_of(lambda a, c: cdist.r_sum_global(
                    a, c, axis_name="data", q=q, block_size=b, scale=a.shape[0]), rows, "z1", "z2"))
            record("roff", grads_of(lambda a, c: cdist.r_off_global(
                a, c, axis_name="data", total_scale=float(inp["z1"].shape[0])), rows, "z1", "z2"))
            vcfg = DecorrConfig(style="vic", reg="sum", q=2, distributed="global", axis_name="data", permute=False)
            zc = shd.NamedSharding(mesh, rows).local(T("zc"))
            for ddof in (0, 1, None):
                res[f"ddof{ddof}"] = engine.regularizer(zc, zc, vcfg, float(zc.shape[0] - 1), ddof=ddof).numpy()
            res["vicmom"] = engine.apply(*(shd.NamedSharding(mesh, rows).local(T(k)) for k in ("zv1", "zv2")),
                                         vcfg)[0].numpy()
            gs = shd.NamedSharding(mesh, rows).local(T("g"))
            res["bf16"] = compression.bf16_psum({"g": gs}, "data")["g"].numpy()
            total, err = compression.int8_psum_ef({"g": gs}, {"g": torch.zeros_like(gs)}, "data")
            res["int8"], res["int8_err"] = total["g"].numpy(), shd.NamedSharding(mesh, rows).gather(err["g"]).numpy()
            # error feedback over 20 steps: the compressed running sum tracks the exact one
            e, acc_c, acc_t = [torch.zeros(16, 4)], torch.zeros(16, 4), torch.zeros(16, 4)
            for i in range(20):
                g = torch.from_numpy(np.random.default_rng(100 + i).standard_normal((64, 4)).astype(np.float32))
                red, e = compression.int8_psum_ef([shd.NamedSharding(mesh, rows).local(g)], e, "data")
                acc_c += red[0]
                acc_t += g.reshape(4, 16, 4).sum(dim=0)
            res["ef_rel"] = np.float64(float(torch.linalg.norm(acc_c - acc_t) / torch.linalg.norm(acc_t)))

    mcfg = ssl.SSLModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cases["widths"].items()})
    tree = {part: [{"w": inp[f"{part}.{i}.w"], "b": inp[f"{part}.{i}.b"]} for i in range(len(getattr(mcfg, f"{part}_widths")))]
            for part in ("backbone", "projector")}
    full_batch = {"view1": T("v1"), "view2": T("v2")}
    perm_fn = lambda s: T(f"perm_s{s}")  # noqa: E731
    batch = ssl.shard_ssl_batch(full_batch, mesh)
    for name, kw in cases["steps"].items():
        for mode in ("global", "tp") if tp else ("global", "local"):
            cfg = DecorrConfig(**kw, distributed=mode)
            opt = adamw()
            specs = ssl.ssl_param_specs(mcfg, cfg, mesh)
            state = ssl.create_sharded_ssl_state(ssl.params_from_jax(tree, mcfg), opt, specs, mesh)
            step, lag = ssl.make_sharded_ssl_train_step(mcfg, cfg, opt, warmup_cosine(cases["lr"], 1, 10), mesh,
                                                        clip_norm=1.0, perm_fn=perm_fn)
            _, _, g0 = lag(state.model, batch, perm_fn(0))
            key = f"step/{mode}/{name}"
            for (pname, _), g in zip(state.model.named_parameters(), g0):
                res[f"{key}/grad0/{pname}"] = (state.shardings[pname].gather(g) if pname in state.shardings else g).numpy()
            losses, norms = [], []
            for _ in range(2):
                state, m = step(state, batch)
                losses.append(float(m[f"{kw['style']}_loss"]))
                norms.append(float(m["grad_norm"]))
            res[f"{key}/losses"], res[f"{key}/grad_norm"] = np.array(losses), np.array(norms)
            for pname, p in state.state_dict()["params"].items():
                res[f"{key}/param/{pname}"] = p.numpy()
    if not tp:
        _, loss_fn = ssl.make_ssl_train_step(mcfg, DecorrConfig(**cases["steps"]["bt-q2-b8"]), sgd_momentum(), None)
        with shd.sharding_context(mesh):
            for kind in ("none", "bf16", "int8_ef"):
                opt = sgd_momentum()
                state = create_train_state(ssl.params_from_jax(tree, mcfg), opt)
                ef = compression.init_error_feedback(list(state.model.parameters()))
                step = make_compressed_dp_step(loss_fn, opt, lambda s: cases["sgd_lr"], "data", kind,
                                               mesh=mesh, perm_fn=perm_fn)
                for _ in range(2):
                    state, m, ef = step(state, batch, ef)
                res[f"dp/{kind}/loss"] = m["bt_loss"].numpy()
                for pname, p in state.model.state_dict().items():
                    res[f"dp/{kind}/param/{pname}"] = p.numpy()
    if rank == 0:
        np.savez(out, **res)
    dist.destroy_process_group()


def _reference_job(inputs, out):
    import os

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from repro.core import regularizers as regs
    from repro.core.losses import ssl_loss
    from repro.decorr import DecorrConfig, engine, modes
    from repro.launch.mesh import make_mesh_for_devices
    from repro.optim import adamw, clip_by_global_norm, sgd_momentum, warmup_cosine
    from repro.optim import compression as comp
    from repro.train.ssl import SSLModelConfig, make_ssl_train_step
    from repro.train.train_state import create_train_state

    inp = dict(np.load(inputs))
    cases = json.loads(str(inp["cases"]))
    J = lambda k: jnp.asarray(inp[k])  # noqa: E731
    key = jax.random.PRNGKey(int(inp["perm_seed"]))
    m4, m22 = make_mesh_for_devices(4, 1), make_mesh_for_devices(4, 2)
    n = inp["z1"].shape[0]
    res = {}
    vcfg = DecorrConfig(style="vic", reg="sum", q=2, distributed="global", axis_name="data", permute=False)

    def global_values(a, c, zc, v1, v2):
        out = [engine.apply(a, c, DecorrConfig(style=s, q=q, block_size=b, distributed="global", axis_name="data"),
                            key)[0] for s, q, b in cases["apply"]]
        out += [modes.r_sum_global(a, c, axis_name="data", q=q, block_size=b, scale=a.shape[0]) for q, b in cases["rsum"]]
        out.append(modes.r_off_global(a, c, axis_name="data", total_scale=float(n)))
        out += [engine.regularizer(zc, zc, vcfg, float(zc.shape[0] - 1), ddof=ddof) for ddof in (0, 1, None)]
        out.append(ssl_loss(v1, v2, vcfg)[0])
        return jnp.stack(out)

    def tp_values(a, c):
        out = [engine.apply(a, c, DecorrConfig(style=s, q=q, block_size=b, distributed="tp", axis_name="data",
                                               model_axis="model"), key)[0] for s, q, b in cases["apply"]]
        out += [modes.r_sum_tp(a, c, model_axis="model", batch_axis="data", q=q, block_size=b, scale=a.shape[0])
                for q, b in cases["rsum_tp"]]
        return jnp.stack(out)

    rows, cells = P("data"), P("data", "model")
    gv = jax.jit(jax.shard_map(global_values, mesh=m4, in_specs=(rows,) * 5, out_specs=P()))(
        J("z1"), J("z2"), J("zc"), J("zv1"), J("zv2"))
    tv = jax.jit(jax.shard_map(tp_values, mesh=m22, in_specs=(cells, cells), out_specs=P()))(J("z1"), J("z2"))
    gv, tv = iter(np.asarray(gv)), iter(np.asarray(tv))
    for s, q, b in cases["apply"]:
        res[f"apply/global/{s}/q{q}/b{b}"] = next(gv)
    for q, b in cases["rsum"]:
        res[f"rsum/q{q}/b{b}"] = next(gv)
    res["roff"] = next(gv)
    for ddof in (0, 1, None):
        res[f"ddof{ddof}"] = next(gv)
    res["vicmom"] = next(gv)
    for s, q, b in cases["apply"]:
        res[f"apply/tp/{s}/q{q}/b{b}"] = next(tv)
    for q, b in cases["rsum_tp"]:
        res[f"rsum_tp/q{q}/b{b}"] = next(tv)

    def compress(gs, es):
        out, new_e = comp.int8_psum_ef({"g": gs}, {"g": es}, "data")
        return comp.bf16_psum({"g": gs}, "data")["g"], out["g"], new_e["g"]

    g = J("g")
    res["bf16"], res["int8"], res["int8_err"] = map(np.asarray, jax.jit(jax.shard_map(
        compress, mesh=m4, in_specs=(rows, rows), out_specs=(P(), P(), rows)))(g, jnp.zeros_like(g)))

    # the single-device oracle on the whole batch: values and input gradients
    def oracle(a, c):
        fns = [lambda a, c, s=s, q=q, b=b: engine.apply(a, c, DecorrConfig(style=s, q=q, block_size=b), key)[0]
               for s, q, b in cases["apply"]]
        fns += [lambda a, c, q=q, b=b: regs.r_sum_auto(a, c, q=q, block_size=b, scale=float(n))
                for q, b in cases["rsum"]]
        fns.append(lambda a, c: regs.r_off(regs.cross_correlation_matrix(a, c, scale=float(n))))
        return [jax.value_and_grad(f, argnums=(0, 1))(a, c) for f in fns]

    outs = iter(jax.jit(oracle)(J("z1"), J("z2")))
    for tag in [f"apply/{s}/q{q}/b{b}" for s, q, b in cases["apply"]] + [f"rsum/q{q}/b{b}" for q, b in cases["rsum"]] + ["roff"]:
        v, (ga, gc) = next(outs)
        res[f"oracle/{tag}"], res[f"oracle/{tag}/dz1"], res[f"oracle/{tag}/dz2"] = map(np.asarray, (v, ga, gc))

    mcfg = SSLModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cases["widths"].items()})
    params = {part: [{"w": J(f"{part}.{i}.w"), "b": J(f"{part}.{i}.b")} for i in range(len(getattr(mcfg, f"{part}_widths")))]
              for part in ("backbone", "projector")}
    batch = {"view1": J("v1"), "view2": J("v2")}
    shards = [{k: v[i * n // 4:(i + 1) * n // 4] for k, v in batch.items()} for i in range(4)]
    rngs = [jax.random.fold_in(jax.random.PRNGKey(0), s) for s in range(2)]

    def flat(tree, tag):
        for part in ("backbone", "projector"):
            for i, layer in enumerate(tree[part]):
                res[f"{tag}/{part}.{i}.weight"] = np.asarray(layer["w"]).T
                res[f"{tag}/{part}.{i}.bias"] = np.asarray(layer["b"])

    stacked = {k: v.reshape((4, n // 4) + v.shape[1:]) for k, v in batch.items()}

    def mean_grad_steps(shard_vg, opt, sched, clip, tag, metric):
        """Two steps on the mean of the 4 shards' gradients (the DDP objective)."""
        state = create_train_state(params, opt)
        losses = []
        for s in range(2):
            (loss, metrics), grads = shard_vg(state.params, stacked, rngs[s])
            grads = jax.tree.map(lambda g: jnp.mean(g, axis=0), grads)
            if s == 0:
                flat(grads, f"{tag}/grad0")
            losses.append(float(jnp.mean(metrics[metric])))
            if clip:
                grads, _ = clip_by_global_norm(grads, 1.0)
            new_params, new_opt = opt.update(grads, state.opt_state, state.params, sched(s))
            state = state._replace(params=new_params, opt_state=new_opt, step=state.step + 1)
        res[f"{tag}/losses"] = np.array(losses)
        flat(state.params, f"{tag}/param")

    for name, kw in cases["steps"].items():
        sched = warmup_cosine(cases["lr"], 1, 10)
        step, loss_fn = make_ssl_train_step(mcfg, DecorrConfig(**kw), adamw(), sched, clip_norm=1.0)
        vg = jax.value_and_grad(loss_fn, has_aux=True)
        # the step, and (used at step 0) the gradients of the state it starts from: one compile
        step_and_grads = jax.jit(lambda st, b, r: (step(st, b), vg(st.params, b, r)[1]))
        state = create_train_state(params, adamw())
        losses, norms = [], []
        for s in range(2):
            (state, m), g = step_and_grads(state, batch, rngs[s])
            if s == 0:
                flat(g, f"oracle/step/{name}/grad0")
            losses.append(float(m[f"{kw['style']}_loss"]))
            norms.append(float(m["grad_norm"]))
        res[f"oracle/step/{name}/losses"], res[f"oracle/step/{name}/grad_norm"] = np.array(losses), np.array(norms)
        flat(state.params, f"oracle/step/{name}/param")
        shard_vg = jax.jit(jax.vmap(vg, in_axes=(None, 0, None)))
        mean_grad_steps(shard_vg, adamw(), sched, True, f"oracle/local/{name}", f"{kw['style']}_loss")
        if name == "bt-q2-b8":  # the compressed step's loss: the same loss_fn
            mean_grad_steps(shard_vg, sgd_momentum(), lambda s: cases["sgd_lr"], False, "oracle/dp", "bt_loss")
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


def _python(fn, *args) -> list:
    """argv of ``python -c`` running ``fn``'s source with string arguments."""
    src = textwrap.dedent(inspect.getsource(fn)) + f"\n{fn.__name__}(*{[str(a) for a in args]!r})\n"
    return [sys.executable, "-c", src]


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1", **extra)
    env.pop("XLA_FLAGS", None)
    return env


CLI = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4", "-m", "repro_torch.train.cli",
       "--tiny", "--steps", "4", "--distributed", "tp", "--model-parallel", "2", "--device", "cpu"]


def run_jobs(tmp) -> dict:
    """Start every job at once in directory ``tmp``, wait for all: {"ref",
    "a", "b": result dicts; "cli": (the first CLI run's stdout, its
    checkpoint directory)}.  ``tools/torch_parity.py`` runs it too."""
    inputs = os.path.join(tmp, "inputs.npz")
    np.savez(inputs, **_inputs())
    path = lambda name: os.path.join(tmp, name)  # noqa: E731
    procs = {"ref": [subprocess.Popen(_python(_reference_job, inputs, path("ref.npz")), env=_env(JAX_PLATFORMS="cpu"),
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]}
    for job, (world, mp_) in {"a": (4, 1), "b": (4, 2)}.items():
        procs[job] = [subprocess.Popen(_python(_port_job, r, world, mp_, inputs, path(f"{job}.npz"), path(f"{job}.store")),
                                       env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                      for r in range(world)]
    ckpt = path("ckpt")
    procs["cli"] = [subprocess.Popen([sys.executable, *CLI, "--ckpt-dir", ckpt], env=_env(),
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    out = {}
    try:
        for job, ps in procs.items():
            for p in ps:
                stdout, stderr = p.communicate(timeout=300)
                if p.returncode != 0:
                    raise RuntimeError(f"{job}: exit {p.returncode}\n{stderr[-3000:]}")
            out[job] = (stdout, ckpt) if job == "cli" else dict(np.load(path(f"{job}.npz")))
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_jobs(str(tmp_path_factory.mktemp("dist")))


def _port(runs, key):
    for job in ("a", "b"):
        if key in runs[job]:
            return runs[job][key]
    raise KeyError(key)


# ---------------------------------------------------------------------------
# forward values against the reference's sharded forward
# ---------------------------------------------------------------------------


def _apply_keys():
    """Every engine case; ``applyk``: a grouped case on the kernel route."""
    return [f"{tag}/{m}/{s}/q{q}/b{b}" for m in ("global", "tp") for s, q, b in CASES["apply"]
            for tag in (("apply", "applyk") if b else ("apply",))]


@pytest.mark.parametrize("key", _apply_keys() + [f"rsum/q{q}/b{b}" for q, b in CASES["rsum"]]
                         + [f"rsum_tp/q{q}/b{b}" for q, b in CASES["rsum_tp"]] + ["roff", "ddof0", "ddof1", "vicmom"])
def test_sharded_forward_matches_reference_sharded_forward(runs, key):
    got, want = float(_port(runs, key)), float(runs["ref"][key.replace("applyk/", "apply/")])
    assert abs(got - want) <= RTOL * abs(want), (got, want)


def test_global_ddof_and_moments_are_the_whole_batch_ones(runs):
    """The twins of ``test_regularizer_global_ddof_uses_exact_effective_scale``
    and ``test_vic_global_uses_global_moments``: n_global - ddof, not the
    legacy (n_local - 1) x P; moments of the whole batch, not the shards'."""
    inp = _inputs()
    zc = torch.from_numpy(inp["zc"])
    cfg = DecorrConfig(style="vic", reg="sum", q=2, permute=False)
    for ddof in (0, 1):
        want = float(engine.regularizer(zc, zc, cfg, float(64 - ddof)))
        assert abs(float(runs["a"][f"ddof{ddof}"]) - want) <= RTOL * abs(want)
    legacy = float(engine.regularizer(zc, zc, cfg, float((64 // 4 - 1) * 4)))
    assert abs(float(runs["a"]["ddofNone"]) - legacy) <= RTOL * abs(legacy)
    assert abs(legacy - float(runs["a"]["ddof1"])) > 1e-3 * abs(legacy)
    z1, z2 = torch.from_numpy(inp["zv1"]), torch.from_numpy(inp["zv2"])
    want = float(ssl_loss(z1, z2, cfg)[0])
    buggy = float(np.mean([float(ssl_loss(z1[i * 16:(i + 1) * 16], z2[i * 16:(i + 1) * 16], cfg)[0]) for i in range(4)]))
    got = float(runs["a"]["vicmom"])
    assert abs(got - want) <= RTOL * abs(want)
    assert abs(buggy - want) > 1e-2 * abs(want)  # shard-local moments would be visibly wrong


def test_compressed_sums_match_the_reference(runs):
    a, ref = runs["a"], runs["ref"]
    # the int8 sums exactly; the carried residuals g - q s to f32 rounding
    assert np.array_equal(a["int8"], ref["int8"])
    assert np.abs(a["int8_err"] - ref["int8_err"]).max() <= 1e-6 * np.abs(_inputs()["g"]).max()
    top = np.abs(ref["bf16"]).max()
    assert np.abs(a["bf16"] - ref["bf16"]).max() <= 2.0 ** (np.floor(np.log2(top)) - 7)  # one bf16 ulp of it
    exact = _inputs()["g"].reshape(4, 16, 16).sum(axis=0)
    rel = lambda x: np.linalg.norm(x - exact) / np.linalg.norm(exact)  # noqa: E731
    assert rel(a["int8"]) < 0.05 and rel(a["bf16"]) < 0.01  # the reference test's bounds
    assert a["ef_rel"] < 0.02  # twin of test_error_feedback_converges_over_steps


# ---------------------------------------------------------------------------
# gradients and steps against the single-device oracle on the whole batch
# ---------------------------------------------------------------------------


def _port_local_grads(style, q, b):
    """The port's single-device local route on the whole batch."""
    inp = _inputs()
    a, c = (torch.from_numpy(inp[k]).requires_grad_() for k in ("z1", "z2"))
    loss, _ = engine.apply(a, c, DecorrConfig(style=style, q=q, block_size=b), torch.from_numpy(inp["perm"]))
    return [g.numpy() for g in torch.autograd.grad(loss, (a, c))]


@pytest.mark.parametrize("key", _apply_keys() + [f"rsum/q{q}/b{b}" for q, b in CASES["rsum"]]
                         + [f"rsum_tp/q{q}/b{b}" for q, b in CASES["rsum_tp"]] + ["roff"])
def test_input_gradients_match_single_device_oracle(runs, key):
    """dL / dz gathered over the ranks (each rank's backward gives its own
    rows' and features' share) against ``jax.grad`` on the whole batch."""
    parts = key.split("/")
    tag = "/".join(["apply"] + parts[2:]) if parts[0].startswith("apply") else "/".join(["rsum"] + parts[1:]) if parts[0] == "rsum_tp" else key
    for i in (1, 2):
        want = runs["ref"][f"oracle/{tag}/dz{i}"]
        got = _port(runs, f"{key}/dz{i}")
        assert _rel(got, want) <= RTOL, (i, _rel(got, want))
        if parts[0].startswith("apply"):
            style, q, b = parts[2], int(parts[3][1:]), None if parts[4] == "bNone" else int(parts[4][1:])
            assert _rel(got, _port_local_grads(style, q, b)[i - 1]) <= RTOL


@pytest.mark.parametrize("mode,job", [("global", "a"), ("local", "a"), ("global", "b"), ("tp", "b")])
@pytest.mark.parametrize("name", list(CASES["steps"]))
def test_sharded_ssl_steps_match_single_device_oracle(runs, name, mode, job):
    """Two AdamW steps, clip on (twins of the reference's sharded-step
    tests): ``global`` / ``tp`` equal ``make_ssl_train_step`` on the whole
    batch; ``local`` equals the step on the mean of the 4 shards' gradients."""
    port, ref = runs[job], runs["ref"]
    oracle = f"oracle/local/{name}" if mode == "local" else f"oracle/step/{name}"
    key = f"step/{mode}/{name}"
    names = [k.split("/")[-1] for k in ref if k.startswith(f"{oracle}/param/")]
    grad0 = _tree_rel({n: port[f"{key}/grad0/{n}"] for n in names}, {n: ref[f"{oracle}/grad0/{n}"] for n in names})
    assert max(grad0.values()) <= RTOL, grad0
    np.testing.assert_allclose(port[f"{key}/losses"], ref[f"{oracle}/losses"], rtol=RTOL)
    if mode != "local":
        np.testing.assert_allclose(port[f"{key}/grad_norm"], ref[f"{oracle}/grad_norm"], rtol=RTOL)
    # AdamW turns a gradient entry that is a rounding residual of an exact 0
    # (the last bias, standardized or centered away; a unit live on one row)
    # into a full-size step of either sign: such entries are held to the
    # step's bound, 2 lr a step; every other entry to 5e-4 of its leaf
    noise = 1e-6 * max(float(np.abs(ref[f"{oracle}/grad0/{n}"]).max()) for n in names)
    for n in names:
        got, want = port[f"{key}/param/{n}"], ref[f"{oracle}/param/{n}"]
        real = np.abs(ref[f"{oracle}/grad0/{n}"]) > noise
        err = np.abs(got.astype(np.float64) - want)
        assert err[real].max(initial=0.0) <= RTOL * np.abs(want).max(), (n, err[real].max() / np.abs(want).max())
        assert err[~real].max(initial=0.0) <= 2 * 2 * CASES["lr"], n


@pytest.mark.parametrize("kind,bound", [("none", RTOL), ("bf16", 0.01), ("int8_ef", 0.05)])
def test_compressed_dp_step_tracks_the_mean_gradient_step(runs, kind, bound):
    """``make_compressed_dp_step`` (SGD with momentum, so an update is linear
    in the gradient): two steps' updates against the step on the mean of
    the 4 shards' gradients — exact to 5e-4 uncompressed, within the
    reference's 0.01 (bf16) / 0.05 (int8) relative bounds compressed."""
    inp, port, ref = _inputs(), runs["a"], runs["ref"]
    for n in [k.split("/")[-1] for k in ref if k.startswith("oracle/dp/param/")]:
        start = inp[n.replace("weight", "w").replace("bias", "b")]
        start = start.T if n.endswith("weight") else start
        got, want = port[f"dp/{kind}/param/{n}"] - start, ref[f"oracle/dp/param/{n}"] - start
        if n == LAST_BIAS:
            continue  # its gradient vanishes: the update has no size to hold relative to
        assert np.linalg.norm(got - want) <= bound * np.linalg.norm(want), (n, np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# config guards, the mesh helpers, a trivial mesh, the CLI
# ---------------------------------------------------------------------------


def test_tp_guards_and_global_degrade_match_reference():
    """Twins of ``TestTpMisconfigGuard`` and ``TestLocalShims``."""
    z = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="model_axis"):
        ssl_loss(z, z + 0.1, DecorrConfig(style="bt", reg="sum", distributed="tp"))
    with pytest.raises(ValueError, match="model_axis"):
        engine.regularizer(z, z, DecorrConfig(style="vic", distributed="tp"), 7.0)
    assert engine.effective_mode(DecorrConfig(distributed="tp", model_axis="model")) == "tp"
    for kw in (dict(reg="off"), dict(reg="sum", block_size=1)):
        with pytest.raises(NotImplementedError, match="R_sum family"):
            engine.regularizer(z, z, DecorrConfig(style="bt", distributed="tp", model_axis="m", **kw), 8.0)
        with pytest.raises(NotImplementedError):
            ref_engine.regularizer(jnp.asarray(z.numpy()), jnp.asarray(z.numpy()),
                                   RefConfig(style="bt", distributed="tp", model_axis="m", **kw), 8.0)
    z1, z2 = z, torch.flip(z, dims=(0,))
    perm = torch.from_numpy(_ref_perm(2, 16))
    la = ssl_loss(z1, z2, DecorrConfig(style="bt", distributed="local"), perm)[0]
    lb = ssl_loss(z1, z2, DecorrConfig(style="bt", distributed="global"), perm)[0]
    assert float(la) == float(lb)
    with pytest.raises(ValueError, match="not bound"):
        engine.standardize(z, DecorrConfig(distributed="global", axis_name="data"))


def test_sharding_rules_and_meshes_without_a_group():
    assert shd.DEFAULT_RULES == ref_sharding.DEFAULT_RULES
    assert shd.current_mesh() is None and shd.named_sharding(("batch",)) is None
    x = torch.ones(3)
    assert shd.shard(x, ("batch",)) is x
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh_for_devices(4, 2)


def test_sharded_step_on_trivial_mesh_matches_unsharded():
    """A group of one in this process: the sharded step (``global`` and
    ``tp`` on a 1 x 1 mesh) equals the unsharded one, and the spec rules
    drop the absent "pod" axis as the reference's do."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh_for_devices(1, 1)
        with pytest.raises(ValueError, match="256 ranks"):
            make_production_mesh()
        with shd.sharding_context(mesh):
            assert shd.logical_to_spec(("batch", "feature", "ff")) == ("data", "model", None)
            assert shd.logical_to_spec(("fsdp", "batch")) == ("data", None)
        with shd.sharding_context(mesh, {"batch": None}):
            assert shd.logical_to_spec(("batch",)) == (None,)
        widths = SSLModelConfig(input_dim=8, backbone_widths=(12,), projector_widths=(16, 16))
        batch = {k: torch.from_numpy(np.random.default_rng(i).standard_normal((16, 8)).astype(np.float32))
                 for i, k in enumerate(("view1", "view2"))}
        perm_fn = lambda s: torch.from_numpy(_ref_perm(0, 16, s))  # noqa: E731
        sched = warmup_cosine(1e-3, 1, 10)
        base = DecorrConfig(style="bt", reg="sum", q=2, block_size=8)
        step_u, _ = make_ssl_train_step(widths, base, adamw(), sched, perm_fn=perm_fn)
        want = float(step_u(create_train_state(init_ssl_model(widths, seed=0), adamw()), batch)[1]["bt_loss"])
        for mode in ("global", "tp"):
            cfg = DecorrConfig(style="bt", reg="sum", q=2, block_size=8, distributed=mode)
            state = create_sharded_ssl_state(init_ssl_model(widths, seed=0), adamw(),
                                             ssl_param_specs(widths, cfg, mesh), mesh)
            step_s, _ = make_sharded_ssl_train_step(widths, cfg, adamw(), sched, mesh, perm_fn=perm_fn)
            assert abs(float(step_s(state, batch)[1]["bt_loss"]) - want) < 1e-5
    finally:
        dist.destroy_process_group()


def test_a_resume_with_no_step_left_rewrites_no_checkpoint(tmp_path):
    """A rerun of a finished run restores its newest checkpoint and writes
    none: rewriting that step's directory could pull it from under the
    ranks still restoring it (only the ranks of one model group meet in a
    gather, so rank 0 may finish first)."""
    from repro_torch.train import LoopConfig, run_training

    widths = SSLModelConfig(input_dim=8, backbone_widths=(12,), projector_widths=(16, 16))
    step, _ = make_ssl_train_step(widths, DecorrConfig(block_size=8), adamw(), lambda s: 1e-3)
    batch = {k: torch.ones(8, 8) * (i + 1) + torch.arange(8.0)[:, None] for i, k in enumerate(("view1", "view2"))}
    cfg = LoopConfig(total_steps=2, ckpt_dir=str(tmp_path), ckpt_interval=10)
    commit = tmp_path / "step_2" / "COMMIT"
    run = lambda: run_training(create_train_state(init_ssl_model(widths, seed=0), adamw()), step,  # noqa: E731
                               lambda s: batch, cfg)
    assert run().step == 2
    inode = commit.stat().st_ino
    assert run().step == 2  # resumed at the end: no step ran
    assert commit.stat().st_ino == inode  # the same file: not written again


def test_torchrun_cli_tp_resumes_and_saves_the_full_tree(runs):
    """``torchrun --nproc-per-node 4 -m repro_torch.train.cli --distributed tp
    --model-parallel 2``: only rank 0 logs; a rerun resumes at step 4 (no
    step runs, the same final Eq. 16); the checkpoint holds the full-width
    output layer and its LARS momentum — the tree an unsharded run writes."""
    first, ckpt = runs["cli"]
    assert first.count("final step=4") == 1 and "mesh={'data': 2, 'model': 2} mode=tp" in first
    again = subprocess.run([sys.executable, *CLI, "--ckpt-dir", ckpt], env=_env(), capture_output=True,
                           text=True, timeout=600)
    assert again.returncode == 0, "\n".join(ln for ln in again.stderr.splitlines() if "Error" in ln)[-3000:]
    assert "final step=4" in again.stdout and "  step " not in again.stdout
    eq16 = lambda out: out.split("(Eq.16) = ")[1].split()[0]  # noqa: E731
    assert eq16(again.stdout) == eq16(first)
    widths = SSLModelConfig(input_dim=256, backbone_widths=(128,), projector_widths=(256, 256))
    template = create_train_state(init_ssl_model(widths), lars()).state_dict()
    tree = restore_checkpoint(ckpt, 4, template)
    assert tree["params"]["projector.1.weight"].shape == (256, 256)
    names = list(tree["params"])
    assert tree["opt_state"]["state"][names.index("projector.1.weight")]["mu"].shape == (256, 256)
