"""The port's 2-D (FSDP over ``data``, TP over ``model``) LM train step on
the CPU (``parallel/fsdp_tp``, ``make_train_step`` on a placed state).

One module fixture starts, all at once: one gloo job of the port a mesh,
4 ranks each, on (data 2, model 2) (whole q and kv heads a rank), (data 1,
model 4) (the reduced archs' 2 kv heads split mid-head, so ``wk`` / ``wv``
take the gather over ``model``) and (pod 2, data 1, model 2) (the batch
over ``("pod", "data")``); and one reference subprocess an arch, on 4 fake
XLA devices.  Each port rank places the reference's weights
(``params_from_jax``, then ``place_train_state``) and takes 2 AdamW steps
of 2 microbatches each, the decorrelation aux loss on, for reduced
gemma2-2b, codeqwen1.5-7b, qwen2-vl-2b (``vision_stub`` embeddings, M-RoPE)
and musicgen-large (audio codes); qwen2-vl's positions differ by row and
by stream, and travel batch-major through the reference's steps (its
microbatch split cuts axis 0).  The oracle is the reference's one-device
step on the whole batch, ordered as the ranks' microbatches (rank r's
microbatch i is its block's i-th half); the reference's GSPMD step, its
weights placed by ``repro.launch.specs.param_sharding`` on the same mesh
(``Auto`` axes), is held against the port too, on one mesh an arch
(``GSPMD``: each mesh is a compilation of its own).

* loss terms and the clip's global norm within 5e-4 relative;
* each step's gradients (the optimizer's input, gathered) within 5e-4 of
  each leaf's largest entry;
* gathered parameters after 2 steps within 5e-4 of each leaf's largest
  entry.  AdamW turns a gradient entry that is mostly rounding into a step
  of either sign: the k bias's entries, whose score shift RoPE's slow
  frequencies barely vary along the keys, cancel to 1e-6 of the leaf's
  largest, so the k bias's entries whose oracle gradient is below 1e-4 of
  its largest are held to the steps' bound, 2 lr a step (the rule of
  ``tests/test_torch_distributed.py``, there at 1e-6 of the tree's
  largest); every other entry of every leaf is held to 5e-4, and the
  gradient check above holds the k bias's entries too;
* every rank's parameter and moment blocks have ``launch/specs``' local
  shapes and the parameters' dtypes;
* the vocabulary-parallel CE where a rank's columns cross a codebook
  boundary equals the unsplit CE, value and gradient;
* a placed MoE or recurrent state raises; the unplaced data-parallel step
  over ``("pod", "data")`` equals the one-device step.
"""

import functools
import inspect
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.data import LMDataConfig, lm_batch  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 5e-4
RESIDUAL = 1e-4  # an oracle gradient entry below this share of its leaf's largest is rounding
ARCHS = ["gemma2-2b", "codeqwen1.5-7b", "qwen2-vl-2b", "musicgen-large"]
MESHES = {"a": [2, 2], "b": [1, 4], "c": [2, 1, 2]}
# the mesh each arch's GSPMD step runs on (one each: every run compiles anew)
GSPMD = {"gemma2-2b": "a", "codeqwen1.5-7b": "b", "qwen2-vl-2b": "c", "musicgen-large": "b"}
CASES = {"archs": ARCHS, "meshes": MESHES, "gspmd": GSPMD, "batch": 8, "seq": 8, "lr": 3e-3, "steps": 2,
         "micro": 2}
METRICS = ("loss", "ce", "decorr_aux", "decorr_var", "decorr_reg", "grad_norm", "lr")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (see tests/test_torch_lm_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _batch_ranks(mesh) -> int:
    """Ranks the batch is split over: the mesh's pod and data axes."""
    return math.prod(mesh[:-1])


@functools.lru_cache(maxsize=None)
def _inputs() -> dict:
    out = {"cases": np.array(json.dumps(CASES))}
    rng = np.random.default_rng(0)
    b, s = CASES["batch"], CASES["seq"]
    for arch in ARCHS:
        rcfg = ref_config(arch).reduced()
        for k, v in _flat(ref_init(jax.random.PRNGKey(0), rcfg)).items():
            out[f"init/{arch}/{k}"] = v
        for st in range(CASES["steps"]):
            key = jax.random.fold_in(jax.random.PRNGKey(0), st)
            out[f"perm/{arch}/{st}"] = np.array(jax.random.permutation(key, rcfg.d_model))
            # the stream of ``data/synthetic.lm_batch`` (numpy on both sides)
            n_q = rcfg.n_codebooks if rcfg.frontend == "audio_codes" else 0
            toks = lm_batch(LMDataConfig(vocab_size=rcfg.vocab_size, batch=b, seq_len=s, n_codebooks=n_q), st)
            out[f"batch/{arch}/{st}/labels"] = toks["labels"]
            if rcfg.frontend == "vision_stub":
                out[f"batch/{arch}/{st}/embeds"] = (0.02 * rng.standard_normal((b, s, rcfg.d_model))).astype(np.float32)
                # M-RoPE's (3, B, S) positions: a shift per stream and row
                shift = rng.integers(0, 32, (3, b, 1))
                out[f"batch/{arch}/{st}/positions"] = (np.arange(s) + shift).astype(np.int32)
            else:
                out[f"batch/{arch}/{st}/tokens"] = toks["tokens"]
    return out


# ---------------------------------------------------------------------------
# the jobs: self-contained functions, each run as ``python -c`` of its source
# ---------------------------------------------------------------------------


def _port_job(rank, world, mesh_shape, inputs, out, store):
    import dataclasses
    import datetime
    import json

    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, mesh_shape = int(rank), int(world), tuple(json.loads(mesh_shape))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    from repro_torch.configs import get_config
    from repro_torch.core.decorrelation import LMDecorrConfig
    from repro_torch.decorr import DecorrConfig
    from repro_torch.launch.mesh import _make_mesh
    from repro_torch.models import ParamTree, init_params, params_from_jax
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.optim.optimizers import AdamW, Optimizer
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.fsdp_tp import place_train_state
    from repro_torch.train import create_train_state, make_train_step

    class RecordingAdamW(AdamW):
        """AdamW that keeps the gradients of every step."""

        def step(self, lr, grads=None):
            self.seen = getattr(self, "seen", []) + [[g.detach().clone() for g in grads]]
            return super().step(lr, grads)

    inp = dict(np.load(inputs))
    cases = json.loads(str(inp["cases"]))
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    mesh = _make_mesh(mesh_shape, axes)
    batch_axes = tuple(a for a in axes if a != "model")
    res = {}

    def config(arch):
        return dataclasses.replace(get_config(arch).reduced(), decorr=LMDecorrConfig(
            enabled=True, decorr=DecorrConfig(style="vic", reg="sum", q=2), nu=0.5, tokens_per_seq=4))

    def nested(arch):
        tree = {}
        for k, v in inp.items():
            if k.startswith(f"init/{arch}/"):
                node = tree
                *head, leaf = k[len(f"init/{arch}/"):].split("/")
                for h in head:
                    node = node.setdefault(h, {})
                node[leaf] = v
        return tree

    def local_batch(arch, s):
        prefix = f"batch/{arch}/{s}/"
        out = {}
        for k, v in inp.items():
            if k.startswith(prefix):
                name = k[len(prefix):]
                spec = (None, batch_axes) if name == "positions" else (batch_axes,)
                out[name] = shd.NamedSharding(mesh, spec).local(torch.from_numpy(v))
        return out

    for arch in cases["archs"]:
        cfg = config(arch)
        opt = Optimizer(RecordingAdamW, adamw().hyper, "adamw")
        state = create_train_state(ParamTree(params_from_jax(cfg, nested(arch), device="cpu")), opt)
        state = place_train_state(state, mesh)
        key = f"{arch}"
        blocks = {name: [list(p.shape), str(p.dtype)] for name, p in state.model.named_parameters()}
        moments = {name: [[list(v.shape), str(v.dtype)] for v in state.opt_state.state[p].values()]
                   for name, p in state.model.named_parameters()}
        res[f"{key}/blocks"] = np.array(json.dumps({"params": blocks, "moments": moments}))
        step = make_train_step(cfg, opt, warmup_cosine(cases["lr"], 0, 10), num_microbatches=cases["micro"],
                               perm_fn=lambda s, arch=arch: torch.from_numpy(inp[f"perm/{arch}/{s}"]))
        mets = []
        for s in range(cases["steps"]):
            state, m = step(state, local_batch(arch, s))
            mets.append({k: float(v) for k, v in m.items()})
        res[f"{key}/metrics"] = np.array(json.dumps(mets))
        names = [name for name, _ in state.model.named_parameters()]
        for s, grads in enumerate(state.opt_state.seen):
            for name, g in zip(names, grads):
                res[f"{key}/grad{s}/{name}"] = state.shardings[name].gather(g).numpy()
        for name, v in state.state_dict()["params"].items():
            res[f"{key}/param/{name}"] = v.numpy()

    if mesh_shape == (2, 1, 2):
        # the unplaced data-parallel step over the two batch axes
        cfg = config("gemma2-2b")
        state = create_train_state(ParamTree(params_from_jax(cfg, nested("gemma2-2b"), device="cpu")), adamw())
        step = make_train_step(cfg, adamw(), warmup_cosine(cases["lr"], 0, 10), num_microbatches=cases["micro"],
                               perm_fn=lambda s: torch.from_numpy(inp[f"perm/gemma2-2b/{s}"]), mesh=mesh,
                               data_axis=batch_axes)
        mets = []
        for s in range(cases["steps"]):
            state, m = step(state, local_batch("gemma2-2b", s))
            mets.append({k: float(v) for k, v in m.items()})
        res["dp/metrics"] = np.array(json.dumps(mets))
        for name, p in state.model.named_parameters():
            res[f"dp/param/{name}"] = p.detach().numpy()

    if mesh_shape == (2, 2):
        # the vocabulary-parallel CE where a rank's columns cross a codebook
        # boundary: 3 codebooks of 6 ids over 2 model ranks, 9 columns each
        from repro_torch.train.step import cross_entropy

        gen = torch.Generator().manual_seed(7)
        full = torch.randn(4, 5, 18, generator=gen, dtype=torch.float64).float()
        labels = torch.randint(0, 6, (4, 5, 3), generator=gen)
        m = int(mesh.get_local_rank(mesh_dim="model"))
        mine = full[..., 9 * m:9 * m + 9].clone().requires_grad_(True)
        with shd.sharding_context(mesh):
            ce = cross_entropy(mine, labels, vocab_start=9 * m, vocab_size=6)
        (g,) = torch.autograd.grad(ce, mine)
        parts = [torch.empty_like(g) for _ in range(2)]
        dist.all_gather(parts, g.contiguous(), group=mesh.get_group("model"))
        res["ce_cross/value"] = np.float64(ce.item())
        res["ce_cross/grad"] = torch.cat(parts, dim=-1).numpy()
        res["ce_cross/logits"] = full.numpy()
        res["ce_cross/labels"] = labels.numpy()
        # archs the layout does not cover yet: the placed step refuses them
        for arch in ("llama4-scout-17b-a16e", "rwkv6-3b"):
            cfg = get_config(arch).reduced()
            state = place_train_state(create_train_state(ParamTree(init_params(cfg, device="cpu")), adamw()), mesh)
            step = make_train_step(cfg, adamw(), warmup_cosine(cases["lr"], 0, 10))
            try:
                step(state, {})
                res[f"refuse/{arch}"] = np.array("no error")
            except NotImplementedError as e:
                res[f"refuse/{arch}"] = np.array(str(e))
    if rank == 0:
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


def _reference_job(arch, inputs, out):
    import os

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import json

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.core.decorrelation import LMDecorrConfig
    from repro.decorr import DecorrConfig
    from repro.launch.specs import param_sharding
    from repro.optim import adamw, warmup_cosine
    from repro.train import create_train_state, make_train_step
    from repro.train.step import _lm_loss_fn

    inp = dict(np.load(inputs))
    cases = json.loads(str(inp["cases"]))
    cfg = dataclasses.replace(get_config(arch).reduced(), decorr=LMDecorrConfig(
        enabled=True, decorr=DecorrConfig(style="vic", reg="sum", q=2), nu=0.5, tokens_per_seq=4))
    tree = {}
    for k, v in inp.items():
        if k.startswith(f"init/{arch}/"):
            node = tree
            *head, leaf = k[len(f"init/{arch}/"):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = jnp.asarray(v)
    # the reference's microbatch split cuts every leaf along axis 0, so
    # M-RoPE's (3, B, S) positions travel batch-major, (B, 3, S), and the
    # loss puts them back
    batches = [{k[len(f"batch/{arch}/{s}/"):]: np.moveaxis(v, 0, 1) if k.endswith("/positions") else v
                for k, v in inp.items() if k.startswith(f"batch/{arch}/{s}/")}
               for s in range(cases["steps"])]

    def loss_fn(p, b, rng):
        if "positions" in b:
            b = dict(b, positions=jnp.moveaxis(b["positions"], 1, 0))
        return _lm_loss_fn(p, b, cfg, rng)

    opt = adamw()
    sched = warmup_cosine(cases["lr"], 0, 10)
    step = jax.jit(make_train_step(cfg, opt, sched, num_microbatches=cases["micro"], loss_fn=loss_fn))
    grad = jax.jit(jax.grad(lambda p, b, rng: loss_fn(p, b, rng)[0]))
    res = {}

    def ordered(batch, n):
        # the ranks' i-th microbatches together make global microbatch i
        b, micro = cases["batch"], cases["micro"]
        part = b // n // micro
        order = [r * micro * part + i * part + j for i in range(micro) for r in range(n) for j in range(part)]
        return {k: jnp.asarray(v[order]) for k, v in batch.items()}

    def record_grad(key, params, batch, s):
        # the step's gradient: the microbatches' mean, as the step takes it
        rng = jax.random.fold_in(jax.random.PRNGKey(0), s)
        half = cases["batch"] // cases["micro"]
        gs = [grad(params, {k: v[i * half:(i + 1) * half] for k, v in batch.items()}, rng)
              for i in range(cases["micro"])]
        for path, v in jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda *g: sum(g) / len(g), *gs))[0]:
            res[f"{key}/grad{s}/" + ".".join(str(p.key) for p in path)] = np.asarray(v)

    def run(key, state, n, place=None):
        mets = []
        for s, batch in enumerate(batches):
            batch = ordered(batch, n)
            if place is None:
                record_grad(key, state.params, batch, s)
            state, m = step(state, batch if place is None else place(batch))
            mets.append({k: float(v) for k, v in m.items()})
        res[f"{key}/metrics"] = np.array(json.dumps(mets))
        for path, v in jax.tree_util.tree_flatten_with_path(state.params)[0]:
            res[f"{key}/param/" + ".".join(str(p.key) for p in path)] = np.asarray(v)

    for n in sorted({int(np.prod(m[:-1])) for m in cases["meshes"].values()}):
        run(f"oracle{n}", create_train_state(tree, opt), n)

    # the GSPMD step: weights placed by the specs' rules, the batch over the batch axes
    for name in (cases["gspmd"][arch],):
        shape = cases["meshes"][name]
        axes = ("pod", "data", "model")[-len(shape):]
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), axes)
        batch_axes = tuple(a for a in axes if a != "model")
        params = jax.tree_util.tree_map_with_path(lambda p, x: jax.device_put(x, param_sharding(p, x, mesh)), tree)

        def place(batch, batch_axes=batch_axes, mesh=mesh):
            return {k: jax.device_put(v, NamedSharding(mesh, P(batch_axes))) for k, v in batch.items()}

        try:
            run(f"gspmd/{name}", create_train_state(params, opt), int(np.prod(shape[:-1])), place)
        except Exception as e:  # recorded: the test holds the port against what ran
            res[f"gspmd/{name}/error"] = np.array(f"{type(e).__name__}: {e}")
    np.savez(out, **res)


def _python(fn, *args) -> list:
    src = textwrap.dedent(inspect.getsource(fn)) + f"\n{fn.__name__}(*{[str(a) for a in args]!r})\n"
    return [sys.executable, "-c", src]


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1", **extra)
    env.pop("XLA_FLAGS", None)
    return env


def run_jobs(tmp) -> dict:
    """Start every job at once in directory ``tmp``; wait for all: {arch:
    the reference's results, mesh name: the port's (rank 0's)}."""
    inputs = os.path.join(tmp, "inputs.npz")
    np.savez(inputs, **_inputs())
    path = lambda name: os.path.join(tmp, name)  # noqa: E731
    procs = {arch: [subprocess.Popen(_python(_reference_job, arch, inputs, path(f"ref_{i}.npz")),
                                     env=_env(JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True)]
             for i, arch in enumerate(ARCHS)}
    files = {arch: path(f"ref_{i}.npz") for i, arch in enumerate(ARCHS)}
    for name, shape in MESHES.items():
        world = math.prod(shape)
        procs[name] = [subprocess.Popen(_python(_port_job, r, world, json.dumps(shape), inputs, path(f"{name}.npz"),
                                                path(f"{name}.store")),
                                        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                       for r in range(world)]
        files[name] = path(f"{name}.npz")
    out = {}
    try:
        for job, ps in procs.items():
            for p in ps:
                _, stderr = p.communicate(timeout=400)
                if p.returncode != 0:
                    raise RuntimeError(f"{job}: exit {p.returncode}\n{stderr[-3000:]}")
            out[job] = dict(np.load(files[job]))
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_jobs(str(tmp_path_factory.mktemp("fsdp_tp")))


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

CELLS = [(arch, mesh) for mesh in MESHES for arch in ARCHS]
IDS = [f"{a.split('-')[0].split('.')[0]}-{'x'.join(map(str, MESHES[m]))}" for a, m in CELLS]


def _check_metrics(got, want, keys=METRICS):
    for s in range(CASES["steps"]):
        for k in keys:
            assert abs(got[s][k] - want[s][k]) <= RTOL * max(abs(want[s][k]), 1e-6), (s, k, got[s][k], want[s][k])


def _check_params(got, want, grad0):
    """Every leaf within 5e-4 of its largest entry, but the k bias's entries
    whose oracle gradient is rounding (see the module note): 2 lr a step."""
    assert got and set(got) == set(want)
    for name, g in got.items():
        w = want[name].astype(np.float64)
        err = np.abs(g.astype(np.float64) - w)
        real = np.ones(w.shape, bool)
        if name.split(".")[-1] == "bk":
            real = np.abs(grad0[name]) > RESIDUAL * np.abs(grad0[name]).max()
        assert err[real].max(initial=0.0) <= RTOL * np.abs(w).max(), (name, err[real].max() / np.abs(w).max())
        assert err[~real].max(initial=0.0) <= 2 * CASES["steps"] * CASES["lr"], name


def _check_grads(port, ref, prefix, oracle):
    """Each step's gradients (the optimizer's input, gathered) within 5e-4
    of each leaf's largest entry: the oracle's, clipped by its norm."""
    want_m = json.loads(str(ref[f"{oracle}/metrics"]))
    for s in range(CASES["steps"]):
        scale = min(1.0, 1.0 / (want_m[s]["grad_norm"] + 1e-9))
        want = _leaves(ref, f"{oracle}/grad{s}/")
        got = _leaves(port, f"{prefix}/grad{s}/")
        assert got and set(want) == set(got)
        for name, g in got.items():
            w = want[name] * scale
            assert np.abs(g - w).max() <= RTOL * np.abs(w).max(), (s, name, np.abs(g - w).max() / np.abs(w).max())


def _leaves(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


@pytest.mark.parametrize("arch,mesh", CELLS, ids=IDS)
def test_placed_step_matches_the_one_device_step(runs, arch, mesh):
    port, ref = runs[mesh], runs[arch]
    oracle = f"oracle{_batch_ranks(MESHES[mesh])}"
    _check_metrics(json.loads(str(port[f"{arch}/metrics"])), json.loads(str(ref[f"{oracle}/metrics"])))
    _check_grads(port, ref, arch, oracle)
    _check_params(_leaves(port, f"{arch}/param/"), _leaves(ref, f"{oracle}/param/"), _leaves(ref, f"{oracle}/grad0/"))


@pytest.mark.parametrize("arch,mesh", list(GSPMD.items()), ids=[IDS[CELLS.index(c)] for c in GSPMD.items()])
def test_placed_step_matches_the_references_gspmd_step(runs, arch, mesh):
    ref = runs[arch]
    assert f"gspmd/{mesh}/error" not in ref, str(ref.get(f"gspmd/{mesh}/error"))
    port = runs[mesh]
    _check_metrics(json.loads(str(port[f"{arch}/metrics"])), json.loads(str(ref[f"gspmd/{mesh}/metrics"])))
    grad0 = _leaves(ref, f"oracle{_batch_ranks(MESHES[mesh])}/grad0/")
    _check_params(_leaves(port, f"{arch}/param/"), _leaves(ref, f"gspmd/{mesh}/param/"), grad0)


class _SpecMesh:
    """A mesh of the given axis sizes for ``launch/specs``' arithmetic."""

    def __init__(self, shape):
        self.axis_names = ("pod", "data", "model")[-len(shape):]
        self.shape = dict(zip(self.axis_names, shape))


@pytest.mark.parametrize("arch,mesh", CELLS, ids=IDS)
def test_each_rank_holds_only_its_blocks(runs, arch, mesh):
    blocks = json.loads(str(runs[mesh][f"{arch}/blocks"]))
    cfg = get_config(arch).reduced()
    spec_mesh = _SpecMesh(MESHES[mesh])
    want, full = {}, {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                sharding = specs.param_sharding(prefix + (k,), torch.empty(v, device="meta"), spec_mesh)
                want[".".join(prefix + (k,))] = list(specs.local_shape(v, sharding))
                full[".".join(prefix + (k,))] = list(v)

    walk(param_shapes(cfg), ())
    assert set(blocks["params"]) == set(want)
    split = 0
    for name, shape in want.items():
        got_shape, dtype = blocks["params"][name]
        assert got_shape == shape, name
        # both AdamW moments: the block's shape, f32 (the reduced configs' moments)
        assert blocks["moments"][name] == [[shape, "torch.float32"]] * 2, name
        split += shape != list(full[name])
    assert split > 0  # the layout splits something on every mesh


def test_vocab_parallel_ce_across_a_codebook_boundary(runs):
    """A rank's columns of the flat (n_codebooks x V) vocabulary may end
    inside a codebook: the CE and its gradient equal the unsplit CE's."""
    from repro_torch.train.step import cross_entropy

    res = runs["a"]
    logits = torch.from_numpy(res["ce_cross/logits"]).requires_grad_(True)
    want = cross_entropy(logits.reshape(4, 5, 3, 6), torch.from_numpy(res["ce_cross/labels"]))
    (grad,) = torch.autograd.grad(want, logits)
    assert abs(float(res["ce_cross/value"]) - want.item()) <= 1e-6 * abs(want.item())
    np.testing.assert_allclose(res["ce_cross/grad"], grad.numpy(), rtol=0, atol=1e-7)


def test_moe_and_recurrent_archs_are_refused(runs):
    for arch in ("llama4-scout-17b-a16e", "rwkv6-3b"):
        msg = str(runs["a"][f"refuse/{arch}"])
        assert arch in msg and "item 7b" in msg, msg


def test_data_parallel_step_reduces_over_pod_and_data(runs):
    """The unplaced step, the batch over ("pod", "data"), equals the oracle."""
    port, ref = runs["c"], runs["gemma2-2b"]
    _check_metrics(json.loads(str(port["dp/metrics"])), json.loads(str(ref["oracle2/metrics"])))
    _check_params(_leaves(port, "dp/param/"), _leaves(ref, "oracle2/param/"), _leaves(ref, "oracle2/grad0/"))
