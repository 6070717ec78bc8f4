"""Data-parallel LM steps, the meshed ``ServeEngine`` and the ``global`` /
``tp`` probes of the port, on the CPU.

One module fixture starts, all at once: two gloo jobs of the port (4 ranks
on a (4, 1) data mesh; a (2, 2) data x model mesh), and one subprocess that
computes the reference's values on 4 fake XLA devices (meshes from
``repro.launch.mesh.make_mesh_for_devices``, whose ``Auto`` axes let the
reference's meshed forwards and ``shard_map`` run).  Every input comes from
a numpy seed or the reference's own initialisation, computed here once.

* ``ServeEngine(mesh=)`` data-parallel on (4, 1) and tp on (2, 2)
  (``model_axis="model"``) against the reference's meshed engine: the full
  (n, d) in request order on every rank, within 1e-5 x max(1, max |z|).
* ``probe_metrics`` in ``global`` ((4, 1): rows over "data") and ``tp``
  ((2, 2): rows over "data", features over "model") against the
  reference's under ``jax.shard_map``, at 5e-4 relative.
* ``make_train_step`` data-parallel on 4 ranks (2 microbatches, 2 AdamW
  steps, the decorrelation aux loss on), with and without
  ``grad_shardings``, for reduced ``gemma2-2b`` and reduced
  ``llama4-scout`` (MoE; also at capacity factor 0.5, where experts drop
  tokens across the ranks' blocks), against the reference's one-device
  step on the whole batch.  The reference's gradients through
  ``shard_map`` fail (ROADMAP queue 3) and its GSPMD step's semantics are
  the one-device step's, so that is the oracle.  A rank's microbatch i is
  its block's i-th half, so the oracle's batch lists the ranks' first
  halves, then their second halves.  Losses within 5e-4 relative,
  parameters within 5e-4 of each leaf's largest entry.
"""

import dataclasses
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

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro_torch.decorr import DecorrConfig  # noqa: E402
from repro_torch.serve.buckets import BucketPolicy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train.ssl import SSLModelConfig, init_ssl_model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 5e-4
N_ROWS, D = 32, 32
CASES = {
    "widths": dict(input_dim=32, backbone_widths=[64], projector_widths=[64, 64]),
    "serve_rows": 24,
    "probe_global": [["bt", 16, 1], ["vic", None, 2], ["bt", None, 2]],
    "probe_tp": [["bt", 16, 1], ["vic", 8, 2]],
    # arch, capacity factor (None: the reduced config's), grad_shardings arms
    "steps": [["gemma2-2b", None, [0, 1]], ["llama4-scout-17b-a16e", None, [0, 1]],
              ["llama4-scout-17b-a16e", 0.5, [0]]],
    "batch": 8,
    "seq": 8,
    "lr": 3e-3,
}


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


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _inputs() -> dict:
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    z1 = f32(N_ROWS, D)
    z1[:, :16] += 0.7 * z1[:, 16:]
    w = CASES["widths"]
    dims = [w["input_dim"], *w["backbone_widths"], *w["projector_widths"]]
    out = dict(z1=z1, z2=(z1 + 0.5 * f32(N_ROWS, D)).astype(np.float32), x=f32(CASES["serve_rows"], w["input_dim"]),
               perm=np.array(jax.random.permutation(jax.random.PRNGKey(5), D)), cases=np.array(json.dumps(CASES)))
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        part, j = ("backbone", i) if i < len(w["backbone_widths"]) else ("projector", i - len(w["backbone_widths"]))
        out[f"ssl/{part}.{j}.w"] = (f32(a, b) / np.sqrt(a)).astype(np.float32)
        out[f"ssl/{part}.{j}.b"] = (0.1 * f32(b)).astype(np.float32)
    for arch, cap, _ in CASES["steps"]:
        rcfg = ref_config(arch).reduced()
        for k, v in _flat(ref_init(jax.random.PRNGKey(0), rcfg)).items():
            out[f"init/{arch}/{k}"] = v
        d = rcfg.d_model
        for s in range(2):
            key = jax.random.fold_in(jax.random.PRNGKey(0), s)
            out[f"perm/{arch}/{s}"] = np.array(jax.random.permutation(key, d))
    return out


# ---------------------------------------------------------------------------
# the jobs: self-contained functions, each run as ``python -c`` of its source
# ---------------------------------------------------------------------------


def _port_job(rank, world, model_parallel, inputs, out, store):
    import dataclasses
    import datetime
    import json

    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, mp_ = int(rank), int(world), int(model_parallel)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=180))
    from repro_torch.configs import get_config
    from repro_torch.core.decorrelation import LMDecorrConfig
    from repro_torch.data.synthetic import LMDataConfig, lm_batch
    from repro_torch.decorr import DecorrConfig, probe_metrics
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.models import ParamTree, params_from_jax
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve.buckets import BucketPolicy
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import create_train_state, make_train_step
    from repro_torch.train.ssl import SSLModelConfig, params_from_jax as ssl_params_from_jax

    inp = dict(np.load(inputs))
    cases = json.loads(str(inp["cases"]))
    mesh = make_mesh_for_devices(world, mp_)
    tp = mp_ > 1
    T = lambda k: torch.from_numpy(inp[k])  # noqa: E731
    res = {}

    # the meshed ServeEngine: every rank encodes the same rows
    mcfg = SSLModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cases["widths"].items()})
    tree = {part: [{"w": inp[f"ssl/{part}.{i}.w"], "b": inp[f"ssl/{part}.{i}.b"]}
                   for i in range(len(getattr(mcfg, f"{part}_widths")))] for part in ("backbone", "projector")}
    policy = BucketPolicy(max_batch=32, align=8)
    eng = ServeEngine(mcfg, ssl_params_from_jax(tree, mcfg), policy=policy, mesh=mesh,
                      model_axis="model" if tp else None, device="cpu")
    eng.warmup()
    z = eng.encode(inp["x"])
    res["serve"] = z.numpy()
    gathered = [torch.empty_like(z) for _ in range(world)]
    dist.all_gather(gathered, z.contiguous())
    res["serve_ranks_agree"] = np.float64(all(torch.equal(g, gathered[0]) for g in gathered))

    # the probes
    spec = ("data", "model") if tp else ("data", None)
    with shd.sharding_context(mesh):
        local = lambda k: shd.NamedSharding(mesh, spec).local(T(k))  # noqa: E731
        for style, b, views in cases["probe_tp" if tp else "probe_global"]:
            mode = "tp" if tp else "global"
            cfg = DecorrConfig(style=style, reg="sum", q=2, block_size=b, distributed=mode, axis_name="data",
                               model_axis="model" if tp else None)
            vals = probe_metrics(local("z1"), local("z2") if views == 2 else None, cfg, T("perm"))
            for k, v in vals.items():
                res[f"probe/{mode}/{style}/b{b}/v{views}/{k}"] = v.numpy()

    # the data-parallel LM step (the (4, 1) mesh only)
    if not tp:
        for arch, cap, arms in cases["steps"]:
            cfg = get_config(arch).reduced()
            if cap is not None:
                cfg = dataclasses.replace(cfg, capacity_factor=cap)
            cfg = dataclasses.replace(cfg, decorr=LMDecorrConfig(
                enabled=True, decorr=DecorrConfig(style="vic", reg="sum", q=2), nu=0.5, tokens_per_seq=4))
            flat = {k[len(f"init/{arch}/"):]: v for k, v in inp.items() if k.startswith(f"init/{arch}/")}
            nested = {}
            for path, v in flat.items():
                node = nested
                *head, leaf = path.split("/")
                for h in head:
                    node = node.setdefault(h, {})
                node[leaf] = v
            data = LMDataConfig(vocab_size=cfg.vocab_size, batch=cases["batch"], seq_len=cases["seq"])
            rows = shd.NamedSharding(mesh, ("data", None))
            for arm in arms:
                opt = adamw()
                state = create_train_state(ParamTree(params_from_jax(cfg, nested, device="cpu")), opt)
                params = list(state.model.parameters())
                specs = None
                if arm:
                    # dim 0 over "data" (the fsdp rule); the embedding's dim 1;
                    # one leaf over "model", which falls back to the all-reduce
                    specs = []
                    for (name, p) in state.model.named_parameters():
                        if name == "embed" and p.dim() == 2:
                            specs.append((None, "data"))
                        elif len(specs) == 1:
                            specs.append(("model",) + (None,) * (p.dim() - 1))
                        else:
                            specs.append(("data",) + (None,) * (p.dim() - 1))
                    fallbacks = sum(1 for s, p in zip(specs, params)
                                    if s[0] == "model" or p.dim() == 0
                                    or (s[0] == "data" and p.shape[0] % world)
                                    or (s[0] is None and p.shape[1] % world))
                    res[f"step/{arch}@{cap}/{arm}/want_fallbacks"] = np.float64(fallbacks)
                step = make_train_step(cfg, opt, warmup_cosine(cases["lr"], 0, 10), num_microbatches=2,
                                       perm_fn=lambda s: T(f"perm/{arch}/{s}"), grad_shardings=specs, mesh=mesh)
                mets = []
                for s in range(2):
                    batch = {k: rows.local(torch.from_numpy(v)) for k, v in lm_batch(data, s).items()}
                    state, m = step(state, batch)
                    mets.append({k: float(v) for k, v in m.items()})
                key = f"step/{arch}@{cap}/{arm}"
                res[f"{key}/metrics"] = np.array(json.dumps(mets))
                for name, p in state.model.named_parameters():
                    res[f"{key}/param/{name}"] = p.detach().numpy()
    if rank == 0:
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


def _reference_job(inputs, out):
    import os

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import json

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.core.decorrelation import LMDecorrConfig
    from repro.data import LMDataConfig, lm_batch
    from repro.decorr import DecorrConfig, probe_metrics
    from repro.launch.mesh import make_mesh_for_devices
    from repro.optim import adamw, warmup_cosine
    from repro.serve.buckets import BucketPolicy
    from repro.serve.engine import ServeEngine
    from repro.train import create_train_state, make_train_step
    from repro.train.ssl import SSLModelConfig

    inp = dict(np.load(inputs))
    cases = json.loads(str(inp["cases"]))
    J = lambda k: jnp.asarray(inp[k])  # noqa: E731
    m4, m22 = make_mesh_for_devices(4, 1), make_mesh_for_devices(4, 2)
    key = jax.random.PRNGKey(5)
    res = {}

    mcfg = SSLModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cases["widths"].items()})
    params = {part: [{"w": J(f"ssl/{part}.{i}.w"), "b": J(f"ssl/{part}.{i}.b")}
                     for i in range(len(getattr(mcfg, f"{part}_widths")))] for part in ("backbone", "projector")}
    policy = BucketPolicy(max_batch=32, align=8)
    res["serve/dp"] = np.asarray(ServeEngine(mcfg, params, policy=policy, mesh=m4).encode(inp["x"]))
    res["serve/tp"] = np.asarray(ServeEngine(mcfg, params, policy=policy, mesh=m22, model_axis="model").encode(inp["x"]))
    res["serve/local"] = np.asarray(ServeEngine(mcfg, params, policy=policy).encode(inp["x"]))

    for mode, mesh, spec in (("global", m4, P("data")), ("tp", m22, P("data", "model"))):
        for style, b, views in cases["probe_tp" if mode == "tp" else "probe_global"]:
            cfg = DecorrConfig(style=style, reg="sum", q=2, block_size=b, distributed=mode, axis_name="data",
                               model_axis="model" if mode == "tp" else None)
            if views == 2:
                fn = lambda a, c, cfg=cfg: probe_metrics(a, c, cfg, key)  # noqa: E731
                args = (J("z1"), J("z2"))
            else:
                fn = lambda a, cfg=cfg: probe_metrics(a, None, cfg, key)  # noqa: E731
                args = (J("z1"),)
            vals = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * len(args), out_specs=P()))(*args)
            for k, v in vals.items():
                res[f"probe/{mode}/{style}/b{b}/v{views}/{k}"] = np.asarray(v)

    half = cases["batch"] // 8  # rows a rank's microbatch holds (4 ranks, 2 microbatches)
    order = [r * 2 * half + i * half + j for i in range(2) for r in range(4) for j in range(half)]
    for arch, cap, _ in cases["steps"]:
        cfg = get_config(arch).reduced()
        if cap is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cap)
        cfg = dataclasses.replace(cfg, decorr=LMDecorrConfig(
            enabled=True, decorr=DecorrConfig(style="vic", reg="sum", q=2), nu=0.5, tokens_per_seq=4))
        flat = {k[len(f"init/{arch}/"):]: v for k, v in inp.items() if k.startswith(f"init/{arch}/")}
        nested = {}
        for path, v in flat.items():
            node = nested
            *head, leaf = path.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = jnp.asarray(v)
        opt = adamw()
        state = create_train_state(nested, opt)
        step = jax.jit(make_train_step(cfg, opt, warmup_cosine(cases["lr"], 0, 10), num_microbatches=2))
        data = LMDataConfig(vocab_size=cfg.vocab_size, batch=cases["batch"], seq_len=cases["seq"])
        mets = []
        for s in range(2):
            state, m = step(state, {k: jnp.asarray(v[order]) for k, v in lm_batch(data, s).items()})
            mets.append({k: float(v) for k, v in m.items()})
        res[f"step/{arch}@{cap}/metrics"] = np.array(json.dumps(mets))
        for k, v in jax.tree_util.tree_flatten_with_path(state.params)[0]:
            res[f"step/{arch}@{cap}/param/" + ".".join(str(p.key) for p in k)] = np.asarray(v)
    np.savez(out, **res)


def _python(fn, *args) -> list:
    src = textwrap.dedent(inspect.getsource(fn)) + f"\n{fn.__name__}(*{[str(a) for a in args]!r})\n"
    return [sys.executable, "-c", src]


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1", **extra)
    env.pop("XLA_FLAGS", None)
    return env


def run_jobs(tmp) -> dict:
    """Start every job at once in directory ``tmp``; wait for all: {"ref",
    "a" ((4, 1)), "b" ((2, 2)): result dicts}."""
    inputs = os.path.join(tmp, "inputs.npz")
    np.savez(inputs, **_inputs())
    path = lambda name: os.path.join(tmp, name)  # noqa: E731
    procs = {"ref": [subprocess.Popen(_python(_reference_job, inputs, path("ref.npz")), env=_env(JAX_PLATFORMS="cpu"),
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]}
    for job, (world, mp_) in {"a": (4, 1), "b": (4, 2)}.items():
        procs[job] = [subprocess.Popen(_python(_port_job, r, world, mp_, inputs, path(f"{job}.npz"), path(f"{job}.store")),
                                       env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                      for r in range(world)]
    out = {}
    try:
        for job, ps in procs.items():
            for p in ps:
                _, stderr = p.communicate(timeout=400)
                if p.returncode != 0:
                    raise RuntimeError(f"{job}: exit {p.returncode}\n{stderr[-3000:]}")
            out[job] = dict(np.load(path(f"{job}.npz")))
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_jobs(str(tmp_path_factory.mktemp("dist_serve")))


# ---------------------------------------------------------------------------
# the meshed ServeEngine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("job,mode", [("a", "dp"), ("b", "tp")])
def test_meshed_serve_engine_matches_the_references(runs, job, mode):
    got, want = runs[job]["serve"], runs["ref"][f"serve/{mode}"]
    assert got.shape == want.shape == (CASES["serve_rows"], CASES["widths"]["projector_widths"][-1])
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol
    # and the reference's meshed engine is its unmeshed one
    assert np.abs(want - runs["ref"]["serve/local"]).max() <= tol
    assert runs[job]["serve_ranks_agree"] == 1.0


def test_meshed_serve_engine_checks_its_mesh():
    cfg = SSLModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in CASES["widths"].items()})
    model = init_ssl_model(cfg, seed=0)
    with pytest.raises(ValueError, match="model_axis"):
        ServeEngine(cfg, model, model_axis="model", device="cpu")

    class FakeMesh:  # the checks read only the axes' sizes
        mesh_dim_names = ("data", "model")
        shape = (2, 3)

    with pytest.raises(ValueError, match="align"):
        ServeEngine(cfg, model, policy=BucketPolicy(align=8), mesh=FakeMesh(), model_axis="model", device="cpu")
    with pytest.raises(ValueError, match="split evenly"):
        ServeEngine(cfg, model, policy=BucketPolicy(align=12), mesh=FakeMesh(), model_axis="model", device="cpu")


# ---------------------------------------------------------------------------
# probe_metrics in global / tp
# ---------------------------------------------------------------------------


PROBES = [("a", "global", *c) for c in CASES["probe_global"]] + [("b", "tp", *c) for c in CASES["probe_tp"]]


@pytest.mark.parametrize("job,mode,style,b,views", PROBES)
def test_probe_metrics_match_the_references_shard_map(runs, job, mode, style, b, views):
    prefix = f"probe/{mode}/{style}/b{b}/v{views}/"
    want = {k[len(prefix):]: v for k, v in runs["ref"].items() if k.startswith(prefix)}
    got = {k[len(prefix):]: v for k, v in runs[job].items() if k.startswith(prefix)}
    # the port also returns mean_abs and std_err, which the reference
    # computes but leaves out of its result (ROADMAP queue 3)
    assert set(got) == set(want) | {"mean_abs", "std_err"}
    assert ("r_off" in want) == (mode == "global")
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, atol=1e-6, err_msg=k)
    assert float(got["n_eff"]) == N_ROWS


# ---------------------------------------------------------------------------
# the data-parallel LM step
# ---------------------------------------------------------------------------


STEPS = [(arch, cap, arm) for arch, cap, arms in CASES["steps"] for arm in arms]


@pytest.mark.parametrize("arch,cap,arm", STEPS,
                         ids=[f"{a.split('-')[0]}-cap{c}-{'sharded' if s else 'allreduce'}" for a, c, s in STEPS])
def test_data_parallel_step_matches_the_one_device_step(runs, arch, cap, arm):
    key = f"step/{arch}@{cap}"
    got_m = json.loads(str(runs["a"][f"{key}/{arm}/metrics"]))
    want_m = json.loads(str(runs["ref"][f"{key}/metrics"]))
    for s in range(2):
        for k in ("loss", "ce", "moe_aux", "decorr_aux", "decorr_reg", "grad_norm", "lr"):
            assert abs(got_m[s][k] - want_m[s][k]) <= RTOL * max(abs(want_m[s][k]), 1e-6), (s, k, got_m[s][k],
                                                                                            want_m[s][k])
    if arm:
        assert got_m[0]["grad_shard_fallbacks"] == float(runs["a"][f"{key}/{arm}/want_fallbacks"]) >= 1
    if arch.startswith("llama4"):
        assert want_m[0]["moe_aux"] > 0
    prefix = f"{key}/{arm}/param/"
    names = [k[len(prefix):] for k in runs["a"] if k.startswith(prefix)]
    assert names
    for name in names:
        got = runs["a"][prefix + name]
        want = runs["ref"][f"{key}/param/" + name.replace("/", ".")]
        assert _rel(got, want) <= RTOL, (name, _rel(got, want))


def test_grad_shardings_plan_picks_the_data_split_dimension():
    """A leaf's gradient is reduce-scattered along the one dimension its
    spec splits over the data axis alone, when the axis size divides it;
    every other spec falls back to the all-reduce; a spec list of the wrong
    length is refused."""
    from repro_torch.train.step import _grad_plan

    params = [torch.zeros(8, 4), torch.zeros(6), torch.zeros(4, 8)]
    assert _grad_plan([("data", None), ("data",), (None, "data")], params, "data", 4) == [0, None, 1]
    assert _grad_plan([("model", None), (None,), ((("data", "model")), None)], params, "data", 4) == [None, None, None]
    with pytest.raises(ValueError, match="3 parameters"):
        _grad_plan([("data", None)], params, "data", 4)

