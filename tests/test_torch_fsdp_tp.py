"""The port's 2-D (FSDP over ``data``, TP over ``model``) LM train step on
the CPU (``parallel/fsdp_tp``, ``make_train_step`` on a placed state).

One module fixture starts, all at once: one gloo job of the port a mesh,
4 ranks each, on (data 2, model 2) (whole q and kv heads a rank), (data 1,
model 4) (the reduced archs' 2 kv heads split mid-head, so ``wk`` / ``wv``
take the gather over ``model``) and (pod 2, data 1, model 2) (the batch
over ``("pod", "data")``); and the reference's processes, on 4 fake XLA
devices.  Each port rank places the reference's weights
(``params_from_jax``, then ``place_train_state``) and takes 2 AdamW steps
of 2 microbatches each, the decorrelation aux loss on, for the six dense
attention archs reduced: gemma2-2b, codeqwen1.5-7b (qwen1.5-110b reduces to
its shapes, bias and RoPE base), qwen2-vl-2b (``vision_stub`` embeddings,
M-RoPE), musicgen-large (audio codes), nemotron-4-340b (the squared-ReLU
MLP), and on (data 1, model 4) gemma2-2b with 2 q heads and 1 kv head,
which do not split over 4 ranks: every rank computes them whole and keeps
the columns of its ``wo`` rows (``models/attention._scoring_attention``);
and the same heads with ``seq_shard_attention``, where each rank scores
its block of ceil(S / 4) query rows and an all-to-all over ``model`` hands
it every row of its ``wo`` rows' columns.
qwen2-vl's positions differ by row and by stream, and travel batch-major
through the reference's steps (its microbatch split cuts axis 0).  The
oracle is the reference's one-device step on the whole batch, ordered as
the ranks' microbatches (rank r's microbatch i is its block's i-th half),
in a process that first draws the weights and writes them for the port's
jobs; the reference's GSPMD step, its weights placed by
``repro.launch.specs.param_sharding`` on the same mesh (``Auto`` axes), is
held against the port too, on one mesh an arch (``GSPMD``: each mesh is a
compilation of its own), in a second process.

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
* the unplaced data-parallel step over ``("pod", "data")`` equals the
  one-device step;
* the sequence-split case's score blocks are (ceil(S / 4), S), the
  whole-heads case's (S, S); and ``launch/perf``'s ``seqpar_attn`` record
  has fewer temporary bytes than ``baseline``'s (reduced gemma2-2b
  ``train_4k`` on (data 1, model 8), a dry run in a subprocess of its own).

``tests/test_torch_fsdp_tp_moe.py`` runs the same jobs (``run_jobs`` of its
own ``CASES``) for the MoE and recurrent archs.
"""

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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 5e-4
RESIDUAL = 1e-4  # an oracle gradient entry below this share of its leaf's largest is rounding
ARCHS = ["gemma2-2b", "codeqwen1.5-7b", "qwen2-vl-2b", "musicgen-large", "nemotron-4-340b"]
MESHES = {"a": [2, 2], "b": [1, 4], "c": [2, 1, 2]}
# the whole-heads case: 2 q heads (1 kv head) on 4 model ranks, computed whole
WHOLE_HEADS = "gemma2-2b:heads2"
# the same heads with ``seq_shard_attention``: the query rows split over model
SEQ_SPLIT = "gemma2-2b:seqpar"
# case name -> (arch, ``reduced()`` overrides)
VARIANTS = {arch: (arch, {}) for arch in ARCHS}
VARIANTS[WHOLE_HEADS] = ("gemma2-2b", {"n_heads": 2, "n_kv_heads": 1})
VARIANTS[SEQ_SPLIT] = ("gemma2-2b", {"n_heads": 2, "n_kv_heads": 1, "seq_shard_attention": True})
# the cases each mesh's job runs
RUNS = {"a": ARCHS, "b": ARCHS + [WHOLE_HEADS, SEQ_SPLIT], "c": ARCHS}
# the mesh each arch's GSPMD step runs on (one each: every run compiles anew)
GSPMD = {"gemma2-2b": "a", "codeqwen1.5-7b": "b", "qwen2-vl-2b": "c", "musicgen-large": "b", "nemotron-4-340b": "a",
         SEQ_SPLIT: "b"}
# AdamW's eps a case ("*": the rest).  At 1e-8 an entry whose gradient is
# near eps, as rounding leaves some (a vocabulary row the batch never
# reads, zero on one side and rounding on the other), takes a step of up
# to lr that rounding decides: the cases below failed at 1e-8 and run at
# 1e-3, under which an entry's step is linear in its gradient below 1e-3.
# nemotron on (data 1, model 4): its embedding ends 9.2e-4 of the leaf's
# largest apart from the oracle's.  ``tests/test_torch_fsdp_tp_moe.py``
# lists its own.
EPS = {"*": 1e-8, "nemotron-4-340b": 1e-3}
CASES = {"variants": VARIANTS, "runs": RUNS, "meshes": MESHES, "gspmd": GSPMD, "batch": 8, "seq": 8, "lr": 3e-3,
         "steps": 2, "micro": 2, "eps": EPS,
         # the unplaced data-parallel step over the mesh's batch axes; the
         # vocabulary-parallel CE across a codebook boundary
         "dp": {"mesh": "c", "case": "gemma2-2b"}, "ce_cross": "a"}
METRICS = ("loss", "ce", "decorr_aux", "decorr_var", "decorr_reg", "grad_norm", "lr")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (see tests/test_torch_lm_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _axes(cases, mesh_name):
    """The axis names of a mesh of ``cases``: given, or the last of ("pod",
    "data", "model")."""
    shape = cases["meshes"][mesh_name]
    return tuple(cases.get("axes", {}).get(mesh_name) or ("pod", "data", "model")[-len(shape):])


def _batch_ranks(cases, mesh_name) -> int:
    """Ranks the batch is split over: the mesh's pod and data axes."""
    return math.prod(n for n, a in zip(cases["meshes"][mesh_name], _axes(cases, mesh_name)) if a != "model")


def _oracles(cases) -> dict:
    """case -> the batch-rank counts its one-device oracle is ordered for."""
    out = {}
    for mesh, names in cases["runs"].items():
        for name in names:
            out.setdefault(name, set()).add(_batch_ranks(cases, mesh))
    if cases.get("dp"):
        out.setdefault(cases["dp"]["case"], set()).add(_batch_ranks(cases, cases["dp"]["mesh"]))
    return {k: sorted(v) for k, v in out.items()}


def _reduced(module, name, cases):
    arch, over = cases["variants"][name]
    return module(arch).reduced(**over)


def _inputs(cases) -> dict:
    out = {"cases": np.array(json.dumps(cases))}
    rng = np.random.default_rng(0)
    b, s = cases["batch"], cases["seq"]
    for name in cases["variants"]:
        rcfg = _reduced(ref_config, name, cases)
        for st in range(cases["steps"]):
            key = jax.random.fold_in(jax.random.PRNGKey(0), st)
            out[f"perm/{name}/{st}"] = np.array(jax.random.permutation(key, rcfg.d_model))
            # the stream of ``data/synthetic.lm_batch`` (numpy on both sides)
            n_q = rcfg.n_codebooks if rcfg.frontend == "audio_codes" else 0
            toks = lm_batch(LMDataConfig(vocab_size=rcfg.vocab_size, batch=b, seq_len=s, n_codebooks=n_q), st)
            out[f"batch/{name}/{st}/labels"] = toks["labels"]
            if rcfg.frontend == "vision_stub":
                out[f"batch/{name}/{st}/embeds"] = (0.02 * rng.standard_normal((b, s, rcfg.d_model))).astype(np.float32)
                # M-RoPE's (3, B, S) positions: a shift per stream and row
                shift = rng.integers(0, 32, (3, b, 1))
                out[f"batch/{name}/{st}/positions"] = (np.arange(s) + shift).astype(np.int32)
            else:
                out[f"batch/{name}/{st}/tokens"] = toks["tokens"]
    return out


# ---------------------------------------------------------------------------
# the jobs: self-contained functions, each run as ``python -c`` of its source
# ---------------------------------------------------------------------------


def _port_job(rank, world, mesh_name, inputs, out, store):
    import dataclasses
    import datetime
    import json
    import os
    import time

    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    from repro_torch.configs import get_config
    from repro_torch.core.decorrelation import LMDecorrConfig
    from repro_torch.decorr import DecorrConfig
    from repro_torch.launch.mesh import _make_mesh
    from repro_torch.models import ParamTree, params_from_jax
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
    mesh_shape = tuple(cases["meshes"][mesh_name])
    axes = tuple(cases.get("axes", {}).get(mesh_name) or ("pod", "data", "model")[-len(mesh_shape):])
    mesh = _make_mesh(mesh_shape, axes)
    batch_axes = tuple(a for a in axes if a != "model")
    res = {}

    def config(name):
        arch, over = cases["variants"][name]
        return dataclasses.replace(get_config(arch).reduced(**over), decorr=LMDecorrConfig(
            enabled=True, decorr=DecorrConfig(style="vic", reg="sum", q=2), nu=0.5, tokens_per_seq=4))

    def optimizer(name, recording=False):
        opt = adamw(eps=cases["eps"].get(name, cases["eps"]["*"]))
        return Optimizer(RecordingAdamW, opt.hyper, "adamw") if recording else opt

    def nested(name):
        # the reference's weights, which its oracle process writes first
        path = cases["init_files"][name]
        for _ in range(2400):
            if os.path.exists(path):
                break
            time.sleep(0.1)
        tree = {}
        for k, v in np.load(path).items():
            node = tree
            *head, leaf = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = v
        return tree

    def local_batch(name, s):
        prefix = f"batch/{name}/{s}/"
        out = {}
        for k, v in inp.items():
            if k.startswith(prefix):
                key = k[len(prefix):]
                spec = (None, batch_axes) if key == "positions" else (batch_axes,)
                out[key] = shd.NamedSharding(mesh, spec).local(torch.from_numpy(v))
        return out

    def steps(name, state, step):
        mets = []
        for s in range(cases["steps"]):
            state, m = step(state, local_batch(name, s))
            mets.append({k: float(v) for k, v in m.items()})
        return state, np.array(json.dumps(mets))

    def perm_fn(name):
        return lambda s: torch.from_numpy(inp[f"perm/{name}/{s}"])

    # the (query rows, key rows) of every score block the attention builds
    from repro_torch.models import attention

    scores = set()
    for fn_name in ("_full_attention", "_offset_prefill_attention", "_chunked_attention"):
        def recording(q, k, *args, _fn=getattr(attention, fn_name), **kw):
            scores.add((q.shape[1], k.shape[1]))
            return _fn(q, k, *args, **kw)

        setattr(attention, fn_name, recording)

    for name in cases["runs"].get(mesh_name, ()):
        scores.clear()
        cfg = config(name)
        opt = optimizer(name, recording=True)
        state = create_train_state(ParamTree(params_from_jax(cfg, nested(name), device="cpu")), opt)
        state = place_train_state(state, mesh)
        blocks = {k: [list(p.shape), str(p.dtype)] for k, p in state.model.named_parameters()}
        moments = {k: [[list(v.shape), str(v.dtype)] for v in state.opt_state.state[p].values()]
                   for k, p in state.model.named_parameters()}
        res[f"{name}/blocks"] = np.array(json.dumps({"params": blocks, "moments": moments}))
        step = make_train_step(cfg, opt, warmup_cosine(cases["lr"], 0, 10), num_microbatches=cases["micro"],
                               perm_fn=perm_fn(name))
        state, res[f"{name}/metrics"] = steps(name, state, step)
        names = [k for k, _ in state.model.named_parameters()]
        for s, grads in enumerate(state.opt_state.seen):
            for k, g in zip(names, grads):
                res[f"{name}/grad{s}/{k}"] = state.shardings[k].gather(g).numpy()
        for k, v in state.state_dict()["params"].items():
            res[f"{name}/param/{k}"] = v.numpy()
        res[f"{name}/scores"] = np.array(json.dumps(sorted(scores)))

    if (cases.get("dp") or {}).get("mesh") == mesh_name:
        # the unplaced data-parallel step over the mesh's batch axes
        name = cases["dp"]["case"]
        cfg = config(name)
        state = create_train_state(ParamTree(params_from_jax(cfg, nested(name), device="cpu")), optimizer(name))
        step = make_train_step(cfg, optimizer(name), warmup_cosine(cases["lr"], 0, 10), num_microbatches=cases["micro"],
                               perm_fn=perm_fn(name), mesh=mesh, data_axis=batch_axes)
        state, res["dp/metrics"] = steps(name, state, step)
        for k, p in state.model.named_parameters():
            res[f"dp/param/{k}"] = p.detach().numpy()

    if cases.get("ce_cross") == mesh_name:
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
    if rank == 0:
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


def _reference_job(name, what, inputs, out):
    """``what``: {"oracles": the batch-rank counts of the one-device runs,
    "gspmd": a mesh name or None, "init": where to write the weights first
    (atomically), or None}."""
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
    from repro.models import init_params
    from repro.optim import adamw, warmup_cosine
    from repro.train import create_train_state, make_train_step
    from repro.train.step import _lm_loss_fn

    inp = dict(np.load(inputs))
    cases = json.loads(str(inp["cases"]))
    arch, over = cases["variants"][name]
    cfg = dataclasses.replace(get_config(arch).reduced(**over), decorr=LMDecorrConfig(
        enabled=True, decorr=DecorrConfig(style="vic", reg="sum", q=2), nu=0.5, tokens_per_seq=4))
    what = json.loads(what)
    tree = init_params(jax.random.PRNGKey(0), cfg)
    if what["init"]:
        flat = {"/".join(str(p.key) for p in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
        np.savez(what["init"] + ".tmp.npz", **flat)
        os.replace(what["init"] + ".tmp.npz", what["init"])
    # the reference's microbatch split cuts every leaf along axis 0, so
    # M-RoPE's (3, B, S) positions travel batch-major, (B, 3, S), and the
    # loss puts them back
    batches = [{k[len(f"batch/{name}/{s}/"):]: np.moveaxis(v, 0, 1) if k.endswith("/positions") else v
                for k, v in inp.items() if k.startswith(f"batch/{name}/{s}/")}
               for s in range(cases["steps"])]

    def loss_fn(p, b, rng):
        if "positions" in b:
            b = dict(b, positions=jnp.moveaxis(b["positions"], 1, 0))
        return _lm_loss_fn(p, b, cfg, rng)

    opt = adamw(eps=cases["eps"].get(name, cases["eps"]["*"]))
    sched = warmup_cosine(cases["lr"], 0, 10)
    step = jax.jit(make_train_step(cfg, opt, sched, num_microbatches=cases["micro"], loss_fn=loss_fn))
    res = {}

    def ordered(batch, n):
        # the ranks' i-th microbatches together make global microbatch i
        b, micro = cases["batch"], cases["micro"]
        part = b // n // micro
        order = [r * micro * part + i * part + j for i in range(micro) for r in range(n) for j in range(part)]
        return {k: jnp.asarray(v[order]) for k, v in batch.items()}

    def leaves(tree):
        return {".".join(str(p.key) for p in path): np.asarray(v, np.float64)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    def run(key, state, n, place=None, mesh=None):
        mets = []
        placement = None
        if mesh is not None:
            # every leaf on the mesh (the step counter and the key
            # replicated), and put back there after each step: the GSPMD
            # step's outputs lie elsewhere, and one compilation serves both
            placement = jax.tree_util.tree_map(
                lambda x: x.sharding if isinstance(x.sharding, NamedSharding) else NamedSharding(mesh, P()), state)
            state = jax.device_put(state, placement)
        for s, batch in enumerate(batches):
            batch = ordered(batch, n)
            m_old = leaves(state.opt_state["m"])
            state, m = step(state, batch if place is None else place(batch))
            if placement is not None:
                state = jax.device_put(state, placement)
            mets.append({k: float(v) for k, v in m.items()})
            if place is None:
                # the step's gradient (the microbatches' mean, clipped) from
                # AdamW's first moment: m' = b1 m + (1 - b1) g
                for k, v in leaves(state.opt_state["m"]).items():
                    res[f"{key}/grad{s}/{k}"] = ((v - 0.9 * m_old[k]) / 0.1).astype(np.float32)
        res[f"{key}/metrics"] = np.array(json.dumps(mets))
        for path, v in jax.tree_util.tree_flatten_with_path(state.params)[0]:
            res[f"{key}/param/" + ".".join(str(p.key) for p in path)] = np.asarray(v)

    for n in what["oracles"]:
        run(f"oracle{n}", create_train_state(tree, opt), n)

    # the GSPMD step: weights placed by the specs' rules, the batch over the batch axes
    for mesh_name in [what["gspmd"]] if what["gspmd"] else []:
        shape = cases["meshes"][mesh_name]
        axes = tuple(cases.get("axes", {}).get(mesh_name) or ("pod", "data", "model")[-len(shape):])
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), axes)
        batch_axes = tuple(a for a in axes if a != "model")
        params = jax.tree_util.tree_map_with_path(lambda p, x: jax.device_put(x, param_sharding(p, x, mesh)), tree)

        def place(batch, batch_axes=batch_axes, mesh=mesh):
            return {k: jax.device_put(v, NamedSharding(mesh, P(batch_axes))) for k, v in batch.items()}

        try:
            n = int(np.prod([k for k, a in zip(shape, axes) if a != "model"]))
            run(f"gspmd/{mesh_name}", create_train_state(params, opt), n, place, mesh)
        except Exception as e:  # recorded: the test holds the port against what ran
            res[f"gspmd/{mesh_name}/error"] = np.array(f"{type(e).__name__}: {e}")
    np.savez(out, **res)


def _python(fn, *args) -> list:
    src = textwrap.dedent(inspect.getsource(fn)) + f"\n{fn.__name__}(*{[str(a) for a in args]!r})\n"
    return [sys.executable, "-c", src]


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1", **extra)
    env.pop("XLA_FLAGS", None)
    return env


def run_jobs(tmp, cases=CASES) -> dict:
    """Start every job of ``cases`` at once in directory ``tmp`` (a case's
    one-device runs and its GSPMD run in two reference processes, the first
    writing the weights the port jobs wait for); wait for all: {case: the
    reference's results, mesh name: the port's (rank 0's)}."""
    path = lambda name: os.path.join(tmp, name)  # noqa: E731
    oracles = _oracles(cases)
    cases = dict(cases, init_files={name: path(f"init_{i}.npz") for i, name in enumerate(oracles)})
    inputs = path("inputs.npz")
    np.savez(inputs, **_inputs(cases))
    procs, files = {}, {}
    for i, (name, ns) in enumerate(oracles.items()):
        jobs = [{"oracles": ns, "gspmd": None, "init": cases["init_files"][name]}]
        if name in cases["gspmd"]:
            jobs.append({"oracles": [], "gspmd": cases["gspmd"][name], "init": None})
        procs[name] = [subprocess.Popen(_python(_reference_job, name, json.dumps(w), inputs, path(f"ref_{i}_{j}.npz")),
                                        env=_env(JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True) for j, w in enumerate(jobs)]
        files[name] = [path(f"ref_{i}_{j}.npz") for j in range(len(jobs))]
    meshes = set(cases["runs"]) | {m for m in ((cases.get("dp") or {}).get("mesh"), cases.get("ce_cross")) if m}
    for name in sorted(meshes):
        world = math.prod(cases["meshes"][name])
        procs[name] = [subprocess.Popen(_python(_port_job, r, world, name, inputs, path(f"{name}.npz"),
                                                path(f"{name}.store")),
                                        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                       for r in range(world)]
        files[name] = [path(f"{name}.npz")]
    out = {}
    try:
        for job, ps in procs.items():
            for p in ps:
                _, stderr = p.communicate(timeout=400)
                if p.returncode != 0:
                    raise RuntimeError(f"{job}: exit {p.returncode}\n{stderr[-3000:]}")
            out[job] = {k: v for f in files[job] for k, v in np.load(f).items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


# the dry run's temp bytes of ``seqpar_attn`` against ``baseline``: reduced
# gemma2-2b (4 heads) train_4k on (data 1, model 8), where the heads do not split
SEQPAR_DRYRUN = r"""
import json
import torch
torch.set_num_threads(1)
from repro_torch.launch import perf
out = {v: perf.build_and_analyze("gemma2-2b", "train_4k", perf.VARIANTS[v], device="cpu", reduced=True,
                                 mesh_shape=(1, 8))["memory"] for v in ("baseline", "seqpar_attn")}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def seqpar_dryrun():
    """The dry run's subprocess, started before the jobs and read after them."""
    proc = subprocess.Popen([sys.executable, "-c", SEQPAR_DRYRUN], env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, seqpar_dryrun):
    return run_jobs(str(tmp_path_factory.mktemp("fsdp_tp")))


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def cells(cases):
    """(case, mesh) of every placed run."""
    return [(name, mesh) for mesh, names in cases["runs"].items() for name in names]


def cell_id(name, mesh, cases=CASES):
    base, _, variant = name.partition(":")
    short = base.split("-")[0].split(".")[0] + (f"-{variant}" if variant else "")
    return f"{short}-{'x'.join(map(str, cases['meshes'][mesh]))}"


CELLS = cells(CASES)
IDS = [cell_id(a, m) for a, m in CELLS]


def _check_metrics(got, want, cases=CASES, keys=METRICS):
    for s in range(cases["steps"]):
        for k in keys:
            assert abs(got[s][k] - want[s][k]) <= RTOL * max(abs(want[s][k]), 1e-6), (s, k, got[s][k], want[s][k])


def _check_params(got, want, grad0, cases=CASES):
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
        assert err[~real].max(initial=0.0) <= 2 * cases["steps"] * cases["lr"], name


def _check_grads(port, ref, prefix, oracle, cases=CASES):
    """Each step's gradients (the optimizer's input, gathered) within 5e-4
    of each leaf's largest entry: the oracle's (the clipped mean of its
    microbatches', read back from its AdamW first moment)."""
    for s in range(cases["steps"]):
        want = _leaves(ref, f"{oracle}/grad{s}/")
        got = _leaves(port, f"{prefix}/grad{s}/")
        assert got and set(want) == set(got)
        for name, g in got.items():
            w = want[name]
            assert np.abs(g - w).max() <= RTOL * np.abs(w).max(), (s, name, np.abs(g - w).max() / np.abs(w).max())


def _leaves(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def check_one_device(runs, name, mesh, cases=CASES):
    """The placed run of ``name`` on ``mesh`` against the one-device step."""
    port, ref = runs[mesh], runs[name]
    oracle = f"oracle{_batch_ranks(cases, mesh)}"
    _check_metrics(json.loads(str(port[f"{name}/metrics"])), json.loads(str(ref[f"{oracle}/metrics"])), cases)
    _check_grads(port, ref, name, oracle, cases)
    _check_params(_leaves(port, f"{name}/param/"), _leaves(ref, f"{oracle}/param/"), _leaves(ref, f"{oracle}/grad0/"),
                  cases)


def check_gspmd(runs, name, mesh, cases=CASES):
    """The placed run of ``name`` on ``mesh`` against the reference's GSPMD step."""
    ref = runs[name]
    assert f"gspmd/{mesh}/error" not in ref, str(ref.get(f"gspmd/{mesh}/error"))
    port = runs[mesh]
    _check_metrics(json.loads(str(port[f"{name}/metrics"])), json.loads(str(ref[f"gspmd/{mesh}/metrics"])), cases)
    grad0 = _leaves(ref, f"oracle{_batch_ranks(cases, mesh)}/grad0/")
    _check_params(_leaves(port, f"{name}/param/"), _leaves(ref, f"gspmd/{mesh}/param/"), grad0, cases)


class _SpecMesh:
    """A mesh of the given axis sizes for ``launch/specs``' arithmetic."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def check_blocks(runs, name, mesh, cases=CASES):
    """Every rank's parameter and moment blocks have ``launch/specs``' local
    shapes and f32 (the reduced leaves; the jobs' ``adamw`` moments)."""
    blocks = json.loads(str(runs[mesh][f"{name}/blocks"]))
    cfg = _reduced(get_config, name, cases)
    spec_mesh = _SpecMesh(cases["meshes"][mesh], _axes(cases, mesh))
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
    for key, shape in want.items():
        got_shape, dtype = blocks["params"][key]
        assert got_shape == shape and dtype == "torch.float32", key
        # both AdamW moments: the block's shape, f32
        assert blocks["moments"][key] == [[shape, "torch.float32"]] * 2, key
        split += shape != list(full[key])
    assert split > 0  # the layout splits something on every mesh


@pytest.mark.parametrize("arch,mesh", CELLS, ids=IDS)
def test_placed_step_matches_the_one_device_step(runs, arch, mesh):
    check_one_device(runs, arch, mesh)


@pytest.mark.parametrize("arch,mesh", list(GSPMD.items()), ids=[cell_id(a, m) for a, m in GSPMD.items()])
def test_placed_step_matches_the_references_gspmd_step(runs, arch, mesh):
    check_gspmd(runs, arch, mesh)


@pytest.mark.parametrize("arch,mesh", CELLS, ids=IDS)
def test_each_rank_holds_only_its_blocks(runs, arch, mesh):
    check_blocks(runs, arch, mesh)


def test_vocab_parallel_ce_across_a_codebook_boundary(runs):
    """A rank's columns of the flat (n_codebooks x V) vocabulary may end
    inside a codebook: the CE and its gradient equal the unsplit CE's."""
    from repro_torch.train.step import cross_entropy

    res = runs[CASES["ce_cross"]]
    logits = torch.from_numpy(res["ce_cross/logits"]).requires_grad_(True)
    want = cross_entropy(logits.reshape(4, 5, 3, 6), torch.from_numpy(res["ce_cross/labels"]))
    (grad,) = torch.autograd.grad(want, logits)
    assert abs(float(res["ce_cross/value"]) - want.item()) <= 1e-6 * abs(want.item())
    np.testing.assert_allclose(res["ce_cross/grad"], grad.numpy(), rtol=0, atol=1e-7)


def check_dp(runs, cases=CASES):
    """The unplaced step, the batch over the mesh's batch axes, equals the oracle."""
    mesh, name = cases["dp"]["mesh"], cases["dp"]["case"]
    port, ref = runs[mesh], runs[name]
    oracle = f"oracle{_batch_ranks(cases, mesh)}"
    _check_metrics(json.loads(str(port["dp/metrics"])), json.loads(str(ref[f"{oracle}/metrics"])), cases)
    _check_params(_leaves(port, "dp/param/"), _leaves(ref, f"{oracle}/param/"), _leaves(ref, f"{oracle}/grad0/"),
                  cases)


def test_data_parallel_step_reduces_over_pod_and_data(runs):
    """The unplaced step, the batch over ("pod", "data"), equals the oracle."""
    check_dp(runs)


def test_sequence_split_attention_scores_a_block_of_query_rows(runs):
    """With ``seq_shard_attention`` and 2 heads on 4 model ranks, each rank
    scores its ceil(S / 4) query rows against every key row; the same heads
    without the flag score every row on every rank."""
    seq, m = CASES["seq"], CASES["meshes"]["b"][1]
    assert json.loads(str(runs["b"][f"{SEQ_SPLIT}/scores"])) == [[-(-seq // m), seq]]
    assert json.loads(str(runs["b"][f"{WHOLE_HEADS}/scores"])) == [[seq, seq]]


def test_sequence_split_attention_lowers_the_dry_runs_temp_bytes(runs, seqpar_dryrun):
    """``launch/perf``'s ``seqpar_attn`` against ``baseline`` on a mesh where
    the heads do not split: fewer temporary bytes (each rank's scores cover
    1 / 8 of the query rows), the same argument bytes."""
    out, err = seqpar_dryrun.communicate(timeout=600)
    assert seqpar_dryrun.returncode == 0, err[-4000:]
    mem = json.loads(out.strip().splitlines()[-1])
    assert mem["seqpar_attn"]["temp_bytes"] < mem["baseline"]["temp_bytes"], mem
    assert mem["seqpar_attn"]["argument_bytes"] == mem["baseline"]["argument_bytes"], mem
