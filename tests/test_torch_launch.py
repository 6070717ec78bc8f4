"""The port's launch analysis tools (``launch/specs``, ``launch/dryrun``,
``launch/perf``) against the reference's, on the CPU.

* specs: for all ten archs at full width, every parameter leaf's shape,
  dtype and ``param_spec`` equal the reference's, and so does the
  ``_divisible`` fallback on the (16, 16) stand-in mesh of the reference's
  test; ``batch_specs``, ``decode_token_specs`` and ``cache_specs`` (shape,
  dtype, spec) equal the reference's on the production meshes — the
  reference on 512 forced XLA host devices, the port on a ``fake`` process
  group of 256 / 512 ranks, each in a subprocess of its own; ``SHAPES`` and
  ``cell_applicable`` are equal.
* ``num_microbatches_for`` and ``model_flops`` equal for every arch x shape
  x mesh.
* ``run_cell`` on reduced archs on a (2, 2) fake mesh (``device="cpu"``):
  status ok, the reference record's keys present, ``argument_bytes`` the
  sum of the rank's inputs and ``reference_argument_bytes`` the specs'
  arithmetic; every train cell, dense or MoE, runs the 2-D step
  (``"layout": "2d"``, ``argument_bytes`` equal to
  ``reference_argument_bytes``), on a multi-pod mesh too, the batch over
  ``("pod", "data")``; every prefill / decode cell of the eight
  attention-only archs runs the 2-D serving steps on (2, 2) and (1, 4)
  (``"layout": "2d"``, the argument bytes the specs'), and so do jamba's
  and rwkv6's decode cells (Mamba and RWKV6 state placed by the specs) and
  rwkv6's ``long_500k``; one full-width cell (gemma2-2b ``decode_32k``,
  single mesh, 2-D) in under 60 s.
* ``VARIANTS``: the reference's names, every override a field of the
  port's ``ArchConfig``; ``baseline`` < ``decorr_sum`` in FLOPs.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402


def _import_keeping_xla_flags(name):
    """Import a reference module whose import sets ``XLA_FLAGS`` (its dry
    run forces 512 host devices) and put the variable back, so this
    worker's JAX keeps the device count every other test file expects."""
    import importlib

    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


ref_perf = _import_keeping_xla_flags("repro.launch.perf")
ref_dryrun = _import_keeping_xla_flags("repro.launch.dryrun")
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import perf, specs  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
ARCHS = list_archs()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: xdist workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """The reference test's stand-in mesh (no devices, no process group)."""

    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


class FakeMultiMesh:
    shape = {"pod": 2, "data": 16, "model": 16}
    axis_names = ("pod", "data", "model")


def _spec(entries):
    """A spec as JSON-able lists, trailing Nones dropped."""
    # one mesh axis is the same whether named alone or in a 1-tuple
    out = [(e[0] if len(e) == 1 else list(e)) if isinstance(e, tuple) else e for e in tuple(entries)]
    while out and out[-1] is None:
        out.pop()
    return out


# the subprocesses: each side's batch / token / cache specs on the
# production meshes, as {"arch|shape|multi_pod": {kind: {path: [shape, dtype, spec]}}}
REF_SPECS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, jax
from repro.configs import get_config, list_archs
from repro.launch import specs as S
from repro.launch.mesh import make_production_mesh

def spec(entries):
    # one mesh axis is the same whether named alone or in a 1-tuple
    out = [(e[0] if len(e) == 1 else list(e)) if isinstance(e, tuple) else e for e in tuple(entries)]
    while out and out[-1] is None:
        out.pop()
    return out

def leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): [list(s.shape), str(s.dtype), spec(s.sharding.spec)]
            for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]}

out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in list_archs():
        cfg = get_config(arch)
        for name, shape in S.SHAPES.items():
            if not S.cell_applicable(cfg, shape)[0]:
                continue
            key = f"{arch}|{name}|{multi}"
            out[key] = {"batch": leaves(S.batch_specs(cfg, shape, mesh)),
                        "tokens": leaves(S.decode_token_specs(cfg, shape.global_batch, mesh)),
                        "caches": leaves(S.cache_specs(cfg, shape.global_batch, shape.seq_len, mesh))}
print(json.dumps(out))
"""

PORT_SPECS = r"""
import json, torch
import torch.distributed as dist
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import dryrun, specs as S
from repro_torch.launch.mesh import make_production_mesh

def spec(entries):
    # one mesh axis is the same whether named alone or in a 1-tuple
    out = [(e[0] if len(e) == 1 else list(e)) if isinstance(e, tuple) else e for e in tuple(entries)]
    while out and out[-1] is None:
        out.pop()
    return out

def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, prefix + k + "/"))
        else:
            out[prefix + k] = [list(v.shape), str(v.dtype).replace("torch.", ""), spec(v.sharding.spec)]
    return out

out = {}
for multi in (False, True):
    dryrun.fake_world(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi)
    for arch in list_archs():
        cfg = get_config(arch)
        for name, shape in S.SHAPES.items():
            if not S.cell_applicable(cfg, shape)[0]:
                continue
            key = f"{arch}|{name}|{multi}"
            out[key] = {"batch": leaves(S.batch_specs(cfg, shape, mesh)),
                        "tokens": leaves(S.decode_token_specs(cfg, shape.global_batch, mesh)),
                        "caches": leaves(S.cache_specs(cfg, shape.global_batch, shape.seq_len, mesh))}
dist.destroy_process_group()
print(json.dumps(out))
"""

# run_cell / perf on reduced archs, a (2, 2) fake mesh, the plain route;
# and the one full-width cell
CELLS = r"""
import json, time
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, hlo_cost, perf
out = {"cells": [], "variants": {}}
for arch, shape, mesh in (("gemma2-2b", "train_4k", (2, 2)), ("gemma2-2b", "decode_32k", (2, 2)),
                          ("rwkv6-3b", "long_500k", (2, 2)), ("llama4-scout-17b-a16e", "train_4k", (2, 2)),
                          ("qwen2-vl-2b", "prefill_32k", (2, 2)), ("llama4-scout-17b-a16e", "train_4k", (2, 2, 2)),
                          ("gemma2-2b", "train_4k", (2, 2, 2))):
    rec = dryrun.run_cell(arch, shape, len(mesh) == 3, device="cpu", cfg=get_config(arch).reduced(), mesh_shape=mesh)
    out["cells"].append(rec)
# a train cell of 8 microbatches, analysed whole and at 3 and 4 microbatches extended
kw = dict(device="cpu", cfg=get_config("llama4-scout-17b-a16e").reduced(), mesh_shape=(2, 2), microbatches=8)
build = lambda **more: dryrun.build_cell("llama4-scout-17b-a16e", "train_4k", False, **kw, **more)  # noqa: E731
fn, args, meta = build()
whole = vars(hlo_cost.analyze(fn, *args))
fn, args, meta = build()
out["extended"] = {"whole": whole, "extended": vars(dryrun.analyze_cell(fn, args, meta, lambda runs: build(runs=runs))),
                   "num_microbatches": meta["num_microbatches"]}
for v in ("baseline", "decorr_sum", "decorr_sum_b128", "decorr_off_baseline"):
    out["variants"][v] = perf.build_and_analyze("gemma2-2b", "train_4k", perf.VARIANTS[v], device="cpu", reduced=True,
                                                mesh_shape=(2, 2))
t0 = time.time()
out["full"] = dryrun.run_cell("gemma2-2b", "decode_32k", False, device="cpu")
out["full_s"] = time.time() - t0
print(json.dumps(out))
"""


# every serving cell of some archs on (2, 2) and (1, 4), reduced: {arch: {cell: record's layout and bytes}}
SERVE_CELLS = r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
out = {}
for arch in sys.argv[1:]:
    for shape in ("prefill_32k", "decode_32k"):
        for mesh in ((2, 2), (1, 4)):
            rec = dryrun.run_cell(arch, shape, False, device="cpu", cfg=get_config(arch).reduced(), mesh_shape=mesh)
            out.setdefault(arch, {})[f"{shape}/{mesh[0]}x{mesh[1]}"] = {
                k: rec.get(k) for k in ("status", "layout", "reference_argument_bytes", "collectives", "traceback")}
            out[arch][f"{shape}/{mesh[0]}x{mesh[1]}"]["memory"] = rec.get("memory")
print(json.dumps(out))
"""
# the attention-only archs, in the subprocesses they share; the recurrent
# archs' decode cells in one more (their prefill_32k cells loop the scan
# over 32768 positions a layer)
SERVE_2D = (("gemma2-2b", "nemotron-4-340b"), ("codeqwen1.5-7b", "musicgen-large"),
            ("qwen2-vl-2b", "qwen1.5-110b"), ("llama4-scout-17b-a16e", "arctic-480b"))
SERVE_RECURRENT = ("jamba-v0.1-52b", "rwkv6-3b")


def _run(code: str, env_extra=None, timeout=600, args=()):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", **(env_extra or {}))
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", code, *args], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jobs():
    """Every subprocess at once: the reference's and the port's specs on the
    production meshes, the port's cells and variants."""
    procs = {"ref": _run(REF_SPECS), "port": _run(PORT_SPECS), "cells": _run(CELLS)}
    for i, archs in enumerate(SERVE_2D):
        procs[f"serve{i}"] = _run(SERVE_CELLS, args=archs)
    procs["serve_recurrent"] = _run(SERVE_CELLS.replace('("prefill_32k", "decode_32k")', '("decode_32k",)'),
                                    args=SERVE_RECURRENT)
    return {k: _result(p) for k, p in procs.items()}


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def _port_leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def test_shapes_and_applicability_equal_the_reference():
    assert ARCHS == ref_list_archs()
    assert {k: dataclasses.astuple(v) for k, v in specs.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in ref_specs.SHAPES.items()}
    assert specs.LONG_CONTEXT_ARCHS == ref_specs.LONG_CONTEXT_ARCHS
    for arch in ARCHS:
        for name in specs.SHAPES:
            assert specs.cell_applicable(get_config(arch), specs.SHAPES[name]) == \
                ref_specs.cell_applicable(ref_config(arch), ref_specs.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch):
    """Every leaf at full width: shape, dtype, ``param_spec`` and the
    ``_divisible`` fallback on the (16, 16) stand-in mesh; the fake spec
    tree carries the same shardings."""
    import jax

    from repro.models.transformer import init_params as ref_init

    rcfg, cfg = ref_config(arch), get_config(arch)
    ref = {tuple(str(k.key) for k in path): leaf
           for path, leaf in jax.tree_util.tree_flatten_with_path(jax.eval_shape(
               lambda: ref_init(jax.random.PRNGKey(0), rcfg)))[0]}
    tree = specs.params_spec_tree(cfg, FakeMesh())
    port = _port_leaves(tree)
    assert set(port) == set(ref)
    for path, leaf in port.items():
        r = ref[path]
        rpath = [jax.tree_util.DictKey(k) for k in path]
        assert tuple(leaf.shape) == tuple(r.shape), path
        assert str(leaf.dtype).replace("torch.", "") == str(r.dtype), path
        spec = specs.param_spec(path, leaf)
        assert _spec(spec) == _spec(ref_specs.param_spec(rpath, r)), path
        div = specs._divisible(leaf.shape, spec, FakeMesh())
        assert div == ref_specs._divisible(r.shape, ref_specs.param_spec(rpath, r), FakeMesh()), path
        assert _spec(leaf.sharding.spec) == (_spec(spec) if div else []), path
    assert tuple(param_shapes(cfg)) == tuple(tree)


def test_opt_state_specs_inherit_the_param_specs():
    cfg = get_config("gemma2-2b").reduced(d_model=128, d_ff=256)
    from repro_torch.optim import adamw

    model = specs.param_tree_module(specs.params_spec_tree(cfg, FakeMesh()), FakeMesh())
    opt = specs.opt_state_spec_tree(adamw(moment_dtype=torch.bfloat16).init, model, FakeMesh())
    for name, p in model.named_parameters():
        for buf in opt.state[p].values():
            assert buf.dtype == torch.bfloat16 and buf.shape == p.shape
            assert buf.sharding.spec == p.sharding.spec, name


def test_batch_token_and_cache_specs_equal_the_reference(jobs):
    ref, port = jobs["ref"], jobs["port"]
    assert set(port) == set(ref) and len(ref) == 2 * (3 * len(ARCHS) + len(specs.LONG_CONTEXT_ARCHS))
    for key in ref:
        for kind in ("batch", "tokens", "caches"):
            assert port[key][kind] == ref[key][kind], (key, kind)


# ---------------------------------------------------------------------------
# num_microbatches_for, model_flops
# ---------------------------------------------------------------------------


def test_microbatches_and_model_flops_equal_the_reference():
    from repro_torch.launch.dryrun import model_flops, num_microbatches_for

    ref_model_flops, ref_micro = ref_dryrun.model_flops, ref_dryrun.num_microbatches_for

    for arch in ARCHS:
        for name, shape in specs.SHAPES.items():
            for mesh in (FakeMesh(), FakeMultiMesh()):
                assert num_microbatches_for(get_config(arch), shape, mesh) == \
                    ref_micro(ref_config(arch), ref_specs.SHAPES[name], mesh), (arch, name)
            assert model_flops(get_config(arch), shape) == ref_model_flops(ref_config(arch), ref_specs.SHAPES[name])


# ---------------------------------------------------------------------------
# run_cell
# ---------------------------------------------------------------------------

REF_RECORD_KEYS = {
    "arch", "shape", "mesh", "n_devices", "mesh_shape", "params", "lower_s", "compile_s", "memory",
    "cost_flops_body_once", "cost_bytes_body_once", "flops", "hbm_bytes", "collectives", "trip_counts",
    "roofline", "hlo_lines", "model_flops_total", "model_flops_per_device", "useful_flops_ratio", "status",
}


def _elems(shape):
    return math.prod(shape)


def _param_elems(cfg):
    def walk(t):
        return sum(walk(v) if isinstance(v, dict) else _elems(v) for v in t.values())

    return walk(param_shapes(cfg))


def _reference_layout_bytes(cfg, mesh_sizes):
    """The rank's parameter bytes under the specs' 2-D layout, by hand."""
    total = 0

    def walk(t, path):
        nonlocal total
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            spec = specs.param_spec(path + (k,), torch.empty(v, device="meta"))
            parts = tuple(spec) + (None,) * (len(v) - len(spec))
            local = list(v)
            ok = all(d % math.prod(mesh_sizes[a] for a in ((p,) if isinstance(p, str) else p)) == 0
                     for d, p in zip(v, parts) if p is not None)
            if ok:
                for i, p in enumerate(parts):
                    if p is not None:
                        local[i] //= math.prod(mesh_sizes[a] for a in ((p,) if isinstance(p, str) else p))
            total += _elems(local) * 4  # reduced configs: f32 leaves
    walk(param_shapes(cfg), ())
    return total


def test_run_cell_records_the_reference_keys_and_bytes(jobs):
    cells = jobs["cells"]["cells"]
    by = {(c["arch"], c["shape"], c["mesh"]): c for c in cells}
    sizes = {"data": 2, "model": 2}
    for rec in cells[:-2]:
        assert rec["status"] == "ok", rec.get("traceback")
        assert REF_RECORD_KEYS <= set(rec), REF_RECORD_KEYS - set(rec)
        assert rec["layout"] == "2d" and rec["n_devices"] == 4 and rec["mesh_shape"] == sizes
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
        assert rec["kernel_launches"] == {}  # the plain route
        assert rec["trip_counts"] == {} and rec["flops"] > 0

    # gemma2 train, the 2-D step: the rank's blocks of the parameters and of
    # two f32 moments, its half of the (256, 4096) tokens and labels
    cfg = get_config("gemma2-2b").reduced()
    train = by[("gemma2-2b", "train_4k", "pod2x2")]
    assert train["num_microbatches"] == 1
    state_bytes = 3 * _reference_layout_bytes(cfg, sizes)
    assert train["memory"]["argument_bytes"] == train["reference_argument_bytes"] == state_bytes + 2 * (128 * 4096 * 4)
    assert train["memory"]["alias_bytes"] == state_bytes  # the state, updated in place
    # FSDP's gathers and reduce-scatters over "data", TP's all-reduces over "model"
    assert min(train["collectives"][k] for k in ("all-gather", "reduce-scatter", "all-reduce")) > 0
    # an MoE arch's train cell: the 2-D step too, the rank's blocks of the
    # parameters (f32) and of two moments of the config's bf16
    moe_cfg = get_config("llama4-scout-17b-a16e").reduced()
    assert moe_cfg.optimizer_moment_dtype == torch.bfloat16
    moe = by[("llama4-scout-17b-a16e", "train_4k", "pod2x2")]
    state_moe = 2 * _reference_layout_bytes(moe_cfg, sizes)  # 4 + 2 + 2 bytes an element: twice the f32 bytes
    assert moe["memory"]["argument_bytes"] == moe["reference_argument_bytes"] == state_moe + 2 * (128 * 4096 * 4)
    assert moe["memory"]["alias_bytes"] == state_moe
    assert min(moe["collectives"][k] for k in ("all-gather", "reduce-scatter", "all-reduce")) > 0

    # gemma2 decode, the 2-D step: the rank's parameter blocks, its 64 of
    # 128 slots of the cache and half their rows (the sequence over
    # model), its 64 tokens and the position
    dec = by[("gemma2-2b", "decode_32k", "pod2x2")]
    kv = cfg.repeats * 64 * 32768 * cfg.n_kv_heads * cfg.hd * 4 * 2 * len(cfg.pattern)
    want = _reference_layout_bytes(cfg, sizes) + kv // 2 + 64 * 4 + 4
    assert dec["memory"]["argument_bytes"] == dec["reference_argument_bytes"] == want
    # the merge's all-gathers and the TP all-reduces over model
    assert min(dec["collectives"][k] for k in ("all-gather", "all-reduce")) > 0
    # rwkv6's long_500k, the 2-D step: the rank's parameter blocks and its
    # RWKV6 state, whole over model (one slot: the batch does not split)
    long = by[("rwkv6-3b", "long_500k", "pod2x2")]
    assert long["memory"]["argument_bytes"] == long["reference_argument_bytes"] > 0

    # the multi-pod train cells: the batch over ("pod", "data"), the 2-D step
    for arch in ("gemma2-2b", "llama4-scout-17b-a16e"):
        multi = by[(arch, "train_4k", "pod2x2x2")]
        assert multi["status"] == "ok", multi.get("traceback")
        assert multi["layout"] == "2d" and multi["n_devices"] == 8
        assert multi["memory"]["argument_bytes"] == multi["reference_argument_bytes"]


def test_extended_microbatches_equal_the_whole_steps_analysis(jobs):
    """A train cell of 8 microbatches analysed at 3 and 4 of them and
    extended by 4 (``dryrun.analyze_cell``) equals the analysis of all 8:
    every count, byte and the high-water mark."""
    rec = jobs["cells"]["extended"]
    assert rec["num_microbatches"] == 8
    assert rec["extended"] == rec["whole"]
    assert rec["whole"]["temp_bytes"] > 0 and rec["whole"]["n_ops"] > 0


def test_one_full_width_cell_within_a_minute(jobs):
    rec, secs = jobs["cells"]["full"], jobs["cells"]["full_s"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert secs < 60.0
    assert rec["n_devices"] == 256 and rec["mesh_shape"] == {"data": 16, "model": 16}
    assert rec["layout"] == "2d"
    assert rec["memory"]["argument_bytes"] == rec["reference_argument_bytes"] > 0
    assert rec["roofline"]["dominant"] == "memory"


def _serve_cells(jobs):
    out = {}
    for k, v in jobs.items():
        if k.startswith("serve"):
            out.update(v)
    return out


@pytest.mark.parametrize("arch", [a for pair in SERVE_2D for a in pair])
def test_serving_cells_run_the_2d_steps(jobs, arch):
    """Every prefill / decode cell of the attention-only archs, on (2, 2)
    and (1, 4): the 2-D serving steps, holding what the specs' layout holds
    a rank; where the kv heads split over model (2 reduced kv heads on (2,
    2)) the prefill moves its rows by an all-to-all."""
    cells = _serve_cells(jobs)[arch]
    assert set(cells) == {f"{s}/{m}" for s in ("prefill_32k", "decode_32k") for m in ("2x2", "1x4")}
    for name, rec in cells.items():
        assert rec["status"] == "ok", (name, rec["traceback"])
        assert rec["layout"] == "2d", name
        assert rec["memory"]["argument_bytes"] == rec["reference_argument_bytes"] > 0, name
    assert cells["prefill_32k/2x2"]["collectives"]["all-to-all"] > 0
    assert cells["prefill_32k/1x4"]["collectives"]["all-to-all"] == 0  # 2 kv heads on 4 ranks: computed whole


@pytest.mark.parametrize("arch", SERVE_RECURRENT)
def test_recurrent_serving_cells_run_the_2d_steps(jobs, arch):
    """jamba's and rwkv6's decode cells (Mamba / RWKV6 state placed by the
    specs) run the 2-D serving steps on (2, 2) and (1, 4): ``"2d"``, what
    the specs' layout holds a rank."""
    for mesh in ("2x2", "1x4"):
        rec = _serve_cells(jobs)[arch][f"decode_32k/{mesh}"]
        assert rec["status"] == "ok", rec["traceback"]
        assert rec["layout"] == "2d"
        assert rec["memory"]["argument_bytes"] == rec["reference_argument_bytes"] > 0


# ---------------------------------------------------------------------------
# perf
# ---------------------------------------------------------------------------


def test_variants_are_the_reference_variants():
    assert list(perf.VARIANTS) == list(ref_perf.VARIANTS) and len(perf.VARIANTS) == 24
    fields = {f.name for f in dataclasses.fields(get_config("gemma2-2b"))}
    for name, v in perf.VARIANTS.items():
        r = ref_perf.VARIANTS[name]
        assert (v.hypothesis, v.cfg_overrides, v.microbatches, v.decorr, v.shard_grad_acc) == \
            (r.hypothesis, r.cfg_overrides, r.microbatches, r.decorr, r.shard_grad_acc)
        assert set(v.cfg_overrides) <= fields, name
        for arch in ("gemma2-2b", "jamba-v0.1-52b"):
            cfg = dataclasses.replace(get_config(arch), **v.cfg_overrides)
            assert all(getattr(cfg, k) == x for k, x in v.cfg_overrides.items())
        if v.decorr is not None:
            d, rd = perf._decorr_cfg(v.decorr), ref_perf._decorr_cfg(v.decorr)
            assert (d.enabled, d.nu, d.tokens_per_seq, d.decorr.reg, d.decorr.block_size, d.decorr.distributed) == \
                (rd.enabled, rd.nu, rd.tokens_per_seq, rd.decorr.reg, rd.decorr.block_size, rd.decorr.distributed)


def test_decorr_variants_add_flops_to_the_baseline(jobs):
    v = jobs["cells"]["variants"]
    base = v["baseline"]["flops"]
    for name in ("decorr_sum", "decorr_sum_b128", "decorr_off_baseline"):
        assert v[name]["flops"] > base, name
        assert v[name]["hypothesis"] == ref_perf.VARIANTS[name].hypothesis
    assert set(v["baseline"]["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant", "bound_s"}
