"""The port's 2-D serving steps on the CPU: ``train/serve``'s prefill and
decode on placed parameters (``parallel/fsdp_tp.place_params``: FSDP over
``data``, heads, FFN, experts, Mamba channels and vocabulary over
``model``) and placed dense decode state (``place_caches``: the slots over
``data``, KV rows and Mamba channels over ``model``, RWKV6 state whole over
``model``), against the reference's one-device steps and its GSPMD steps.

One module fixture starts, all at once: a 4-rank gloo job of the port a
mesh, on (data 2, model 2) and (data 1, model 4), and one reference process
a mesh on 4 fake XLA devices (``make_mesh_for_devices``: ``Auto`` axes).
An arch's weights are drawn once, by the reference process of its first
mesh, and written for the port's jobs and the other process.  For each
arch of its mesh a reference process runs the GSPMD steps (parameters put
by ``launch/specs.param_sharding``, caches by ``cache_specs``, the prompts
over ``data``) and, where the arch runs on no later mesh, the one-device
steps.  Each run prefills 16 tokens of B = 4 slots into L = 32 rows (8
rows a rank on (1, 4), where the reduced window of 16 crosses blocks) and
decodes 12 teacher-forced tokens; on (1, 4) the last of them bring the last
rank's block live.  gemma2-2b on (1, 4) decodes a second time with a (B,)
``cache_len`` from per-slot lengths 16, 12, 18 and 20 (slot 3 writes row
31 last).

The cases: reduced gemma2-2b, codeqwen1.5-7b (kv heads split over
``model`` on (2, 2): the prefill's all-to-all from heads to sequence),
llama4-scout (experts over ``model``, the whole batch's routing) and
jamba-v0.1-52b (Mamba state's channels over ``model``, MoE and attention
layers between) on both meshes; qwen2-vl-2b (embeddings and M-RoPE
positions that differ by row and stream), arctic-480b (top-2 experts and a
dense residual) and rwkv6-3b (4 heads: each rank's heads of the
replicated state, all-gathered after each step) on (2, 2); musicgen-large
(audio codes, a vocabulary split across codebooks) and rwkv6-3b with
``rwkv_head_dim=32`` (2 heads on 4 ranks: every head whole) on (1, 4).
jamba on (1, 4) also prefills a 2-token prompt, shorter than the Mamba
conv's 3 rows of history, into placed state.  Held, at every step:

* the logits within 1e-4 x max(1, max |logit|) of the reference's
  one-device steps and of its GSPMD steps (``PERF.md`` §2's logit bound);
* after the last step, the caches and state gathered from every rank's
  block within the same bound of the reference's (one-device and GSPMD);
* every rank's cache and state blocks have ``launch/specs.cache_sharding``'s
  local shapes.
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

from repro.configs import get_config as ref_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import init_caches  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = 1e-4  # of max(1, max |logit|): the port's logit bound
MESHES = {"a": [2, 2], "b": [1, 4]}
# rwkv6 with 2 heads of 32, which do not split over 4 model ranks
RWKV_WHOLE_HEADS = "rwkv6-3b@hd32"
# case -> (arch, ``reduced()`` overrides), where a case is not its arch
VARIANTS = {RWKV_WHOLE_HEADS: ["rwkv6-3b", {"rwkv_head_dim": 32}]}
RUNS = {"a": ["gemma2-2b", "codeqwen1.5-7b", "llama4-scout-17b-a16e", "qwen2-vl-2b", "arctic-480b", "jamba-v0.1-52b",
              "rwkv6-3b"],
        "b": ["gemma2-2b", "codeqwen1.5-7b", "llama4-scout-17b-a16e", "musicgen-large", "jamba-v0.1-52b",
              RWKV_WHOLE_HEADS]}
# the case that decodes again with per-slot lengths, and its mesh
SLOTS = ("gemma2-2b", "b")
# the case that also prefills a prompt shorter than the Mamba conv's
# history (d_conv - 1 = 3 rows) from placed state, and its mesh
SHORT = ("jamba-v0.1-52b", "b")
CASES = {"meshes": MESHES, "runs": RUNS, "variants": VARIANTS, "slots": SLOTS, "short": SHORT, "short_prompt": 2,
         "batch": 4, "max_len": 32, "prompt": 16, "steps": 12, "slot_lens": [16, 12, 18, 20]}


def _config(get_config, case, cases=CASES):
    """The reduced config of a case of ``cases`` (``get_config``: the port's or the reference's)."""
    arch, over = cases["variants"].get(case, [case, {}])
    return get_config(arch).reduced(**over)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (see tests/test_torch_lm_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _archs(cases):
    """arch -> the meshes it runs on."""
    out = {}
    for mesh, archs in cases["runs"].items():
        for arch in archs:
            out.setdefault(arch, []).append(mesh)
    return out


def _inputs(cases) -> dict:
    """The prompts and the teacher-forced decode inputs of every arch, from
    one numpy seed: tokens (codes for audio), or embeddings and M-RoPE
    positions shifted by row and stream for a vision frontend."""
    out = {"cases": np.array(json.dumps(cases))}
    rng = np.random.default_rng(0)
    b, s, n = cases["batch"], cases["prompt"], cases["steps"]
    for arch in _archs(cases):
        cfg = _config(ref_config, arch, cases)
        if cfg.frontend == "vision_stub":
            shift = rng.integers(0, 8, (3, b, 1))
            out[f"{arch}/prefill/embeds"] = (0.02 * rng.standard_normal((b, s, cfg.d_model))).astype(np.float32)
            out[f"{arch}/prefill/positions"] = (np.arange(s) + shift).astype(np.int32)
            for j in range(n):
                out[f"{arch}/decode{j}/embeds"] = (0.02 * rng.standard_normal((b, 1, cfg.d_model))).astype(np.float32)
                out[f"{arch}/decode{j}/positions"] = (s + j + shift).astype(np.int32)
            continue
        codes = (cfg.n_codebooks,) if cfg.frontend == "audio_codes" else ()
        out[f"{arch}/prefill/tokens"] = rng.integers(0, cfg.vocab_size, (b, s) + codes).astype(np.int32)
        for j in range(n):
            out[f"{arch}/decode{j}/tokens"] = rng.integers(0, cfg.vocab_size, (b, 1) + codes).astype(np.int32)
        if cases["short"][0] == arch:
            out[f"{arch}/short/tokens"] = rng.integers(0, cfg.vocab_size, (b, cases["short_prompt"])).astype(np.int32)
    return out


# ---------------------------------------------------------------------------
# the jobs: self-contained functions, each run as ``python -c`` of its source
# ---------------------------------------------------------------------------


def _port_job(rank, world, inputs, out_dir, store, init_dir, mesh_name):
    """One rank of the port's gloo job on mesh ``mesh_name`` (``world``
    devices); rank 0 writes the results to ``<out_dir>/<mesh_name>.npz``."""
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
    from repro_torch.launch.mesh import _make_mesh
    from repro_torch.models import init_caches, params_from_jax
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.fsdp_tp import place_caches, place_params
    from repro_torch.train.serve import make_decode_step, make_prefill_step

    inp = dict(np.load(inputs))
    cases = json.loads(str(inp["cases"]))

    def weights(arch):
        # the reference's weights, which its process writes first
        path = os.path.join(init_dir, f"{arch}.npz")
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

    def local(arch, step):
        prefix = f"{arch}/{step}/"
        return {k[len(prefix):]: shd.NamedSharding(mesh, (None, "data") if k.endswith("positions") else ("data",))
                .local(torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v))
                for k, v in inp.items() if k.startswith(prefix)}

    def run(key, cfg, params, lens=None, prompt="prefill"):
        b, n = cases["batch"], cases["steps"] if prompt == "prefill" else 0
        caches = place_caches(init_caches(cfg, b, cases["max_len"], device="cpu"), cfg, mesh)
        res[f"{key}/blocks"] = np.array(json.dumps({f"{pos}/{k}": list(v.shape) for pos, leafs in caches.items()
                                                    for k, v in leafs.items()}))
        prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
        logits, caches = prefill(params, caches, **local(arch, prompt))
        res[f"{key}/logits/prefill"] = rows.gather(logits).numpy()
        for j in range(n):
            if lens is None:
                cache_len = cases["prompt"] + j
            else:
                cache_len = rows.local(torch.tensor(lens) + j)
            logits, caches = decode(params, caches, cache_len, **local(arch, f"decode{j}"))
            res[f"{key}/logits/decode{j}"] = rows.gather(logits).numpy()
        for pos, leafs in caches.items():
            for k, v in leafs.items():
                res[f"{key}/cache/{pos}/{k}"] = v.placement.gather(v).numpy()

    mesh = _make_mesh(tuple(cases["meshes"][mesh_name]), ("data", "model"))
    rows = shd.NamedSharding(mesh, ("data",))  # the slots' blocks
    res = {}
    for arch in cases["runs"][mesh_name]:
        name, over = cases["variants"].get(arch, [arch, {}])
        cfg = get_config(name).reduced(**over)
        params = place_params(params_from_jax(cfg, weights(arch), device="cpu"), mesh)
        run(arch, cfg, params)
        if cases["slots"] == [arch, mesh_name]:
            run(f"{arch}:slots", cfg, params, cases["slot_lens"])
        if cases["short"] == [arch, mesh_name]:
            run(f"{arch}:short", cfg, params, prompt="short")
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{mesh_name}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


def _reference_job(mesh_name, inputs, out, init_dir):
    """The reference's GSPMD steps on mesh ``mesh_name`` (4 fake XLA
    devices) of every arch that runs there, and the one-device steps of
    those whose last mesh it is.  An arch's weights are drawn once, by the
    process of its first mesh, and written (atomically) for the port's jobs
    and the other process."""
    import os

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import contextlib
    import json
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.launch import specs
    from repro.launch.mesh import make_mesh_for_devices
    from repro.models import init_params
    from repro.models.transformer import init_caches
    from repro.parallel.sharding import sharding_context
    from repro.train.serve import make_decode_step, make_prefill_step

    inp = dict(np.load(inputs))
    cases = json.loads(str(inp["cases"]))
    b, n = cases["batch"], cases["steps"]
    shape = cases["meshes"][mesh_name]
    mesh = make_mesh_for_devices(4, shape[1])
    res = {}

    def drawn_here(arch):
        return [m for m, archs in cases["runs"].items() if arch in archs][0] == mesh_name

    def weights(arch, cfg):
        # drawn by the process of the arch's first mesh, which writes them
        # for the port's jobs and the other meshes' processes
        path = os.path.join(init_dir, f"{arch}.npz")
        if drawn_here(arch):
            params = init_params(jax.random.PRNGKey(0), cfg)
            flat = {"/".join(str(p.key) for p in path): np.asarray(v)
                    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
            np.savez(path + ".tmp.npz", **flat)
            os.replace(path + ".tmp.npz", path)
            return params
        for _ in range(2400):
            if os.path.exists(path):
                break
            time.sleep(0.1)
        params = {}
        for k, v in np.load(path).items():
            node = params
            *head, leaf = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = jnp.asarray(v)
        return params

    def one_arch(arch):
        name, over = cases["variants"].get(arch, [arch, {}])
        cfg = get_config(name).reduced(**over)
        params = weights(arch, cfg)

        def step_inputs(step):
            prefix = f"{arch}/{step}/"
            return {k[len(prefix):]: v for k, v in inp.items() if k.startswith(prefix)}

        steps = {}

        def jitted(m):
            # one pair of jitted steps a mesh: the per-slot run reuses the
            # prefill's compilation
            if m not in steps:
                def pf(p, c, inputs):
                    with sharding_context(m) if m is not None else contextlib.nullcontext():
                        return make_prefill_step(cfg)(p, c, **inputs)

                def df(p, c, cache_len, inputs):
                    with sharding_context(m) if m is not None else contextlib.nullcontext():
                        return make_decode_step(cfg)(p, c, cache_len, **inputs)

                steps[m] = (jax.jit(lambda p, c, **inputs: pf(p, c, inputs)),
                            jax.jit(lambda p, c, cache_len, **inputs: df(p, c, cache_len, inputs)))
            return steps[m]

        def run(key, m=None, lens=None, prompt="prefill"):
            prefill, decode = jitted(m)
            if m is None:
                p, caches, place, placed = params, init_caches(cfg, b, cases["max_len"]), lambda x: x, None
            else:
                p = jax.tree_util.tree_map_with_path(
                    lambda q, x: jax.device_put(x, specs.param_sharding(q, x, m)), params)
                placed = jax.tree_util.tree_map(lambda s: s.sharding, specs.cache_specs(cfg, b, cases["max_len"], m))
                caches = jax.device_put(init_caches(cfg, b, cases["max_len"]), placed)

                def place(inputs):
                    return {k: jax.device_put(v, NamedSharding(m, P(None, "data") if k == "positions" else P("data")))
                            for k, v in inputs.items()}
            logits, caches = prefill(p, caches, **place(step_inputs(prompt)))
            res[f"{arch}/{key}/logits/prefill"] = np.asarray(logits)
            for j in range(n if prompt == "prefill" else 0):
                if placed is not None:
                    caches = jax.device_put(caches, placed)  # one compilation for every step
                cache_len = jnp.asarray(cases["prompt"] + j if lens is None else np.asarray(lens) + j, jnp.int32)
                logits, caches = decode(p, caches, cache_len, **place(step_inputs(f"decode{j}")))
                res[f"{arch}/{key}/logits/decode{j}"] = np.asarray(logits)
            for path, v in jax.tree_util.tree_flatten_with_path(caches)[0]:
                res[f"{arch}/{key}/cache/" + "/".join(str(q.key) for q in path)] = np.asarray(v)

        slots = cases["slots"] == [arch, mesh_name]
        try:
            run(f"gspmd/{mesh_name}", mesh)
            if slots:
                run(f"gspmd/{mesh_name}:slots", mesh, cases["slot_lens"])
            if cases["short"] == [arch, mesh_name]:
                run(f"gspmd/{mesh_name}:short", mesh, prompt="short")
        except Exception as e:  # recorded: the test holds the port against what ran
            res[f"{arch}/gspmd/{mesh_name}/error"] = np.array(f"{type(e).__name__}: {e}")
        if [m for m, archs in cases["runs"].items() if arch in archs][-1] == mesh_name:
            run("one")
            if cases["slots"][0] == arch:
                run("one:slots", lens=cases["slot_lens"])
            if cases["short"][0] == arch:
                run("one:short", prompt="short")

    for arch in sorted(cases["runs"][mesh_name], key=lambda a: not drawn_here(a)):  # the weights it draws first
        one_arch(arch)
    np.savez(out, **res)


def _python(fn, *args) -> list:
    src = textwrap.dedent(inspect.getsource(fn)) + f"\n{fn.__name__}(*{[str(a) for a in args]!r})\n"
    return [sys.executable, "-c", src]


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1", **extra)
    env.pop("XLA_FLAGS", None)
    return env


def run_jobs(tmp, cases=CASES) -> dict:
    """Start every job at once in directory ``tmp``; wait for all: {arch:
    the reference's results, mesh name: the port's (rank 0's)}."""
    path = lambda name: os.path.join(tmp, name)  # noqa: E731
    inputs = path("inputs.npz")
    np.savez(inputs, **_inputs(cases))
    procs, files = {}, {}
    for name in cases["runs"]:
        files[f"ref/{name}"] = path(f"ref_{name}.npz")
        procs[f"ref/{name}"] = [subprocess.Popen(_python(_reference_job, name, inputs, files[f"ref/{name}"], tmp),
                                                 env=_env(JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True)]
    for name in cases["runs"]:
        world = math.prod(cases["meshes"][name])
        procs[f"port/{name}"] = [subprocess.Popen(_python(_port_job, r, world, inputs, tmp, path(f"{name}.store"), tmp,
                                                          name),
                                                  env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                                 for r in range(world)]
    for name in cases["runs"]:
        files[name] = path(f"{name}.npz")
    try:
        for job, ps in procs.items():
            for p in ps:
                _, stderr = p.communicate(timeout=400)
                if p.returncode != 0:
                    raise RuntimeError(f"{job}: exit {p.returncode}\n{stderr[-3000:]}")
        out = {job: dict(np.load(f)) for job, f in files.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    ref = {k: v for name in cases["runs"] for k, v in out.pop(f"ref/{name}").items()}
    for arch in _archs(cases):
        out[arch] = {k[len(arch) + 1:]: v for k, v in ref.items() if k.startswith(arch + "/")}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_jobs(str(tmp_path_factory.mktemp("serve2d")))


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def cells(cases=CASES):
    """(key, case, mesh) of every placed run (key: the case, or
    ``case:slots`` for the per-slot decode, ``case:short`` for the short
    prompt's prefill)."""
    out = [(arch, arch, mesh) for mesh, archs in cases["runs"].items() for arch in archs]
    for variant in ("slots", "short"):
        arch, mesh = cases[variant]
        if arch in cases["runs"].get(mesh, ()):
            out.append((f"{arch}:{variant}", arch, mesh))
    return out


def cell_id(key, mesh, cases=CASES):
    base, _, variant = key.partition(":")
    arch, _, over = base.partition("@")
    short = arch.split("-")[0].split(".")[0] + "".join(f"-{v}" for v in (over, variant) if v)
    return f"{short}-{'x'.join(map(str, cases['meshes'][mesh]))}"


CELLS = cells()
IDS = [cell_id(k, m) for k, _, m in CELLS]


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= BOUND * max(1.0, np.abs(want).max()), (what, err, np.abs(want).max())


def _steps(key, cases=CASES):
    """The steps of run ``key``: the short prompt's is its prefill alone."""
    return ["prefill"] + ([] if key.endswith(":short") else [f"decode{j}" for j in range(cases["steps"])])


def _reference_key(key, oracle, mesh):
    """The reference result that holds the port's run ``key``: the
    one-device steps (``one``) or the GSPMD steps on ``mesh``."""
    variant = key.partition(":")[2]
    base = "one" if oracle == "one" else f"gspmd/{mesh}"
    return base + (f":{variant}" if variant else "")


def check_logits(runs, key, arch, mesh, oracle, cases=CASES):
    port, ref = runs[mesh], runs[arch]
    assert f"gspmd/{mesh}/error" not in ref, str(ref.get(f"gspmd/{mesh}/error"))
    want = _reference_key(key, oracle, mesh)
    for step in _steps(key, cases):
        _close(port[f"{key}/logits/{step}"], ref[f"{want}/logits/{step}"], (key, mesh, oracle, step))


def check_caches(runs, key, arch, mesh, cases=CASES):
    port, ref = runs[mesh], runs[arch]
    names = [k.split("/cache/")[1] for k in port if k.startswith(f"{key}/cache/")]
    assert names
    for oracle in ("one", "gspmd"):
        want = _reference_key(key, oracle, mesh)
        for name in names:
            _close(port[f"{key}/cache/{name}"], ref[f"{want}/cache/{name}"], (key, mesh, oracle, name))


class _SpecMesh:
    """A (data, model) mesh of the given sizes for ``launch/specs``' arithmetic."""

    def __init__(self, shape):
        self.mesh_dim_names = ("data", "model")
        self.shape = tuple(shape)


@pytest.mark.parametrize("key,arch,mesh", CELLS, ids=IDS)
def test_placed_steps_match_the_one_device_steps(runs, key, arch, mesh):
    check_logits(runs, key, arch, mesh, "one")


@pytest.mark.parametrize("key,arch,mesh", CELLS, ids=IDS)
def test_placed_steps_match_the_references_gspmd_steps(runs, key, arch, mesh):
    check_logits(runs, key, arch, mesh, "gspmd")


@pytest.mark.parametrize("key,arch,mesh", CELLS, ids=IDS)
def test_gathered_cache_blocks_match_the_references_caches(runs, key, arch, mesh):
    check_caches(runs, key, arch, mesh)


@pytest.mark.parametrize("key,arch,mesh", CELLS, ids=IDS)
def test_each_rank_holds_only_its_cache_rows(runs, key, arch, mesh):
    """Every rank's cache and state blocks have ``cache_sharding``'s local
    shapes: the slots over ``data``, KV rows and Mamba channels over
    ``model``, RWKV6 state whole over ``model``."""
    blocks = json.loads(str(runs[mesh][f"{key}/blocks"]))
    cfg = _config(get_config, arch)
    spec_mesh = _SpecMesh(CASES["meshes"][mesh])
    want, full = {}, {}
    for pos, leafs in init_caches(cfg, CASES["batch"], CASES["max_len"], device="cpu").items():
        for k, v in leafs.items():
            full[f"{pos}/{k}"] = list(v.shape)
            want[f"{pos}/{k}"] = list(specs.local_shape(v.shape, specs.cache_sharding(cfg, (pos, k), v.shape,
                                                                                       spec_mesh)))
    assert blocks == want
    data, model = CASES["meshes"][mesh]
    di = cfg.ssm_expand * cfg.d_model
    for name, s in want.items():
        assert s[1] == CASES["batch"] // data, name
        leaf = name.split("/")[1]
        if leaf in ("k", "v"):
            assert s[2] == CASES["max_len"] // model, name
        elif leaf in ("conv", "ssm"):  # the channels over model
            assert s[3 if leaf == "conv" else 2] == di // model, name
        else:  # RWKV6 state: whole over model
            assert s[2:] == full[name][2:], name
