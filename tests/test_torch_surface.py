"""The port's public surface against the reference's, read from source.

For every module ``src/repro/<path>.py`` (one case each), its twin
``src/repro_torch/<path>.py`` must exist and bind every public top-level
function and class of the reference module under the same name, and every
same-named function, class constructor and public method must take each of
the reference's parameters by name.  A difference that is there by design
stands in ``BY_DESIGN`` (names) or ``BY_DESIGN_PARAMS`` (parameters), each
with the port object or parameter that takes its place and a one-line
reason; the test checks that each named counterpart exists in the port's
source and that each entry still names a real difference.  Last, the port's
``core`` package exports every name the reference's does.

Only ``ast`` reads the sources: neither package is imported, and no JAX is
needed.
"""

import ast
import os

import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
REF = os.path.join(SRC, "repro")
PORT = os.path.join(SRC, "repro_torch")

REF_MODULES = sorted(
    os.path.relpath(os.path.join(d, f), REF).replace(os.sep, "/")
    for d, _, files in os.walk(REF)
    for f in files
    if f.endswith(".py")
)

# reference module or "module:Name" -> (the port file or "file:Name[.attr]"
# that takes its place, why)
BY_DESIGN = {
    "kernels/pallas_utils.py": (
        "kernels/utils.py", "the kernels' shared helpers (padding, DFT bases) are not Pallas-specific here"),
    "kernels/pallas_utils.py:pad_to_tiles": (
        "kernels/utils.py:pad_axis", "the CUDA kernels mask ragged tiles: only per-axis semantic padding is used"),
    "kernels/paged_attention/kernel.py:paged_decode_kernel_call": (
        "kernels/paged_attention/kernel.py:paged_decode_attention", "the wrapper launches the CUDA kernel itself"),
    "kernels/paged_attention/ops.py:paged_decode_attention_raw": (
        "kernels/paged_attention/kernel.py:paged_decode_attention", "one wrapper: no jit / custom_vjp layer to split"),
    "kernels/paged_attention/ops.py:paged_decode_attention": (
        "kernels/paged_attention/kernel.py:paged_decode_attention", "the route is chosen from the tensor's device"),
    "kernels/paged_attention/ops.py:paged_decode_jnp": (
        "kernels/paged_attention/ops.py:paged_decode_plain", "the plain PyTorch gather route under its port name"),
    "launch/hlo_cost.py:Op": (
        "launch/hlo_cost.py:analyze", "no HLO text: analyze records each dispatched torch op where a parsed line stood"),
    "launch/hlo_cost.py:HLOAnalysis": (
        "launch/hlo_cost.py:OpAnalysis", "the same fields, counted from dispatched ops instead of HLO"),
    "launch/hlo_cost.py:analyze_hlo": (
        "launch/hlo_cost.py:analyze", "analyses a call under a dispatch mode instead of compiled HLO text"),
    "models/attention.py:attn_init": (
        "models/transformer.py:init_params", "one seeded init of the whole tree replaces the per-module inits"),
    "models/common.py:init_rms_norm": (
        "models/transformer.py:init_params", "one seeded init of the whole tree replaces the per-module inits"),
    "models/common.py:mlp_init": (
        "models/transformer.py:init_params", "one seeded init of the whole tree replaces the per-module inits"),
    "models/moe.py:moe_init": (
        "models/transformer.py:init_params", "one seeded init of the whole tree replaces the per-module inits"),
    "models/ssm.py:mamba_init": (
        "models/transformer.py:init_params", "one seeded init of the whole tree replaces the per-module inits"),
    "models/ssm.py:rwkv_init": (
        "models/transformer.py:init_params", "one seeded init of the whole tree replaces the per-module inits"),
    "train/ssl.py:init_ssl_params": (
        "train/ssl.py:init_ssl_model", "the parameters live in an nn.Module, SSLModel"),
    "train/ssl.py:backbone_apply": ("train/ssl.py:SSLModel.backbone_apply", "a method of the module"),
    "train/ssl.py:projector_apply": ("train/ssl.py:SSLModel.projector_apply", "a method of the module"),
    "train/ssl.py:embed": ("train/ssl.py:SSLModel.forward", "the module's forward"),
    "tune/cost.py:compiled_with_cost": (
        "tune/cost.py:compiled_cost", "no AOT executable: the cost of one analysed call"),
    "tune/space.py:vmem_bytes": ("tune/space.py:smem_bytes", "the H100's shared memory takes VMEM's place"),
}

# "module:function(param)" or "module:Class.method(param)" -> (the port
# parameter, or "file:Name" where the port has none, that takes its place, why)
_PERM = ("perm", "explicit permutation indices: JAX's threefry keys have no torch twin")
BY_DESIGN_PARAMS = {
    "checkpoint/checkpointer.py:restore_checkpoint(shardings)": (
        "template", "each leaf lands on the device of the template's leaf"),
    "checkpoint/manager.py:CheckpointManager.restore_latest(shardings)": (
        "template", "each leaf lands on the device of the template's leaf"),
    "core/decorrelation.py:lm_decorrelation_loss(perm_key)": _PERM,
    "core/losses.py:barlow_twins_loss(perm_key)": _PERM,
    "core/losses.py:vicreg_loss(perm_key)": _PERM,
    "core/losses.py:ssl_loss(perm_key)": _PERM,
    "core/sumvec.py:frequency_accumulator(precision_dtype)": (
        "core/sumvec.py:frequency_accumulator", "always f32 (complex64 bins), the reference's default; no caller sets it"),
    "core/sumvec.py:grouped_frequency_accumulator(precision_dtype)": (
        "core/sumvec.py:grouped_frequency_accumulator",
        "always f32 (complex64 bins), the reference's default; no caller sets it"),
    "core/permutation.py:permutation_for_step(key)": ("seed", "a seeded torch stream replaces the PRNG key"),
    "core/permutation.py:permute_views(key)": _PERM,
    "decorr/engine.py:regularizer(perm_key)": _PERM,
    "decorr/engine.py:barlow_twins(perm_key)": _PERM,
    "decorr/engine.py:vicreg(perm_key)": _PERM,
    "decorr/engine.py:apply(perm_key)": _PERM,
    "decorr/modes.py:r_sum_tp(perm_key)": _PERM,
    "decorr/probe.py:probe_metrics(perm_key)": _PERM,
    "kernels/xcorr_offdiag/kernel.py:off_diagonal_sq_sum_raw(tile_d)": (
        "kernels/xcorr_offdiag/kernel.py:TILE", "the CUDA kernel's C tile is fixed at compile time"),
    "kernels/xcorr_offdiag/kernel.py:off_diagonal_sq_sum_raw(tile_n)": (
        "kernels/xcorr_offdiag/kernel.py:TILE", "the batch stage is fixed in the CUDA kernel beside its tile"),
    "kernels/pallas_utils.py:dft_matrices(dtype)": (
        "device", "the bases are f32 constants cached per device: every kernel takes f32 operands"),
    "kernels/pallas_utils.py:full_dft_matrices(dtype)": (
        "device", "the bases are f32 constants cached per device: every kernel takes f32 operands"),
    "kernels/pallas_utils.py:irfft_basis(dtype)": (
        "device", "the bases are f32 constants cached per device: every kernel takes f32 operands"),
    "launch/dryrun.py:run_cell(keep_hlo)": (
        "launch/hlo_cost.py:analyze", "no HLO to keep: the record's hlo_lines counts the ops analyze saw"),
    "models/common.py:dense_init(key)": ("gen", "a torch.Generator replaces the PRNG key"),
    "models/common.py:dense_init(d_in)": ("shape", "the weight's shape, d_in = shape[-2]"),
    "models/common.py:dense_init(d_out)": ("shape", "the weight's shape, d_out = shape[-1]"),
    "models/common.py:dense_init(scale)": ("shape", "the scale is 1 / sqrt(shape[-2]), the reference's default"),
    "models/transformer.py:init_params(key)": ("seed", "a seeded torch stream replaces the PRNG key"),
    "obs/perf.py:ExecTimer.attach_compiled(compiled)": (
        "analysis", "no compiled executable: its OpAnalysis is attached"),
    "optim/optimizers.py:global_norm(tree)": ("tensors", "a list of tensors in place of a pytree"),
    "serve/common.py:make_prompt(key)": ("seed", "a seeded torch stream replaces the PRNG key"),
    "serve/engine.py:ServeEngine.__init__(params)": ("model", "the parameters live in an SSLModel"),
    "serve/engine.py:ServeEngine.__init__(dtype)": ("model", "the model serves in its parameters' f32"),
    "serve/engine.py:ContinuousLMEngine.__init__(reset_on_retire)": (
        "serve/engine.py:ContinuousLMEngine.release", "always zeroes a retired slot, the reference's default; no caller"
        " turns it off"),
    "serve/engine.py:ContinuousLMEngine.__init__(compact_on_retire)": (
        "serve/engine.py:ContinuousLMEngine.release", "always compacts the pool, the reference's default; no caller"
        " turns it off"),
    "serve/loadgen.py:run_naive(probe)": (
        "serve/service.py:EmbeddingService", "a probe watches batched traffic through the service; no caller probes"
        " the per-request baseline"),
    "serve/loadgen.py:compare_speculative(obs)": (
        "serve/service.py:LMService", "each arm's service keeps its own Obs; no caller passes one in"),
    "serve/loadgen.py:compare_prefix_sharing(obs)": (
        "serve/service.py:LMService", "each arm's service keeps its own Obs; no caller passes one in"),
    "serve/loadgen.py:make_lm_fabric(embed_params)": ("embed_model", "the parameters live in an SSLModel"),
    "serve/loadgen.py:compare_fabric(embed_params)": ("embed_model", "the parameters live in an SSLModel"),
    "serve/loadgen.py:tp_oracle_err(params)": ("model", "the parameters live in an SSLModel"),
    "train/train_state.py:create_train_state(params)": ("model", "the parameters live in an nn.Module"),
    "tune/dispatch.py:best_impl(backend)": ("device", "the route follows the tensor's device"),
}


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def _bound(tree):
    """Names a module binds at top level, and {class: its body's names}."""
    names, members = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                members[node.name] = {n.name for n in node.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
                members[node.name] |= {t.id for n in node.body if isinstance(n, ast.AnnAssign)
                                       for t in [n.target] if isinstance(t, ast.Name)}
        elif isinstance(node, ast.Assign):
            names |= {n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return names, members


def _public(tree):
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not n.name.startswith("_")]


def _callables(tree):
    """{qualname: def node} of public functions, and of classes' __init__
    and public methods."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                        m.name == "__init__" or not m.name.startswith("_")):
                    out[f"{node.name}.{m.name}"] = m
    return out


def _params(fn):
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs if p.arg not in ("self", "cls")]


def _twin(rel):
    return BY_DESIGN[rel][0] if rel in BY_DESIGN else rel


def _port_has(target):
    """Whether "file" or "file:Name[.attr]" exists in the port's source."""
    path, _, name = target.partition(":")
    full = os.path.join(PORT, path)
    if not os.path.isfile(full):
        return False
    if not name:
        return True
    names, members = _bound(_tree(full))
    top, _, attr = name.partition(".")
    return top in names and (not attr or attr in members.get(top, ()))


def surface_gaps(rel):
    """The differences of one reference module that ``BY_DESIGN`` /
    ``BY_DESIGN_PARAMS`` do not cover: missing files, names and
    parameters, as strings."""
    ref = _tree(os.path.join(REF, rel))
    twin = os.path.join(PORT, _twin(rel))
    if not os.path.isfile(twin):
        return [f"{rel}: no twin file {_twin(rel)}"]
    port = _tree(twin)
    names, _ = _bound(port)
    gaps = [f"{rel}:{n}" for n in _public(ref) if n not in names and f"{rel}:{n}" not in BY_DESIGN]
    port_defs = _callables(port)
    for qual, fn in _callables(ref).items():
        if qual not in port_defs:
            continue
        have = _params(port_defs[qual])
        gaps += [f"{rel}:{qual}({p})" for p in _params(fn)
                 if p not in have and f"{rel}:{qual}({p})" not in BY_DESIGN_PARAMS]
    return gaps


@pytest.mark.parametrize("rel", REF_MODULES)
def test_port_covers_the_reference_module(rel):
    assert surface_gaps(rel) == []


def test_by_design_entries_name_real_differences_with_port_counterparts():
    for key, (target, reason) in BY_DESIGN.items():
        rel, _, name = key.partition(":")
        assert reason and os.path.isfile(os.path.join(REF, rel)), key
        if name:
            assert name in _public(_tree(os.path.join(REF, rel))), key
            assert name not in _bound(_tree(os.path.join(PORT, _twin(rel))))[0], f"{key} has a same-named twin"
        else:
            assert not os.path.isfile(os.path.join(PORT, rel)), f"{key} has a twin file"
        assert _port_has(target), f"{key} -> {target}: not in the port"
    for key, (target, reason) in BY_DESIGN_PARAMS.items():
        where, _, param = key[:-1].partition("(")
        rel, _, qual = where.partition(":")
        fn = _callables(_tree(os.path.join(REF, rel)))[qual]
        port_fn = _callables(_tree(os.path.join(PORT, _twin(rel))))[qual]
        assert reason and param in _params(fn) and param not in _params(port_fn), key
        assert (target in _params(port_fn)) if ":" not in target else _port_has(target), f"{key} -> {target}"


def _imported(path):
    return {a.asname or a.name for node in _tree(path).body if isinstance(node, ast.ImportFrom) for a in node.names}


def test_core_exports_every_name_of_the_reference_core():
    want = _imported(os.path.join(REF, "core", "__init__.py"))
    assert len(want) == 34
    assert want - _imported(os.path.join(PORT, "core", "__init__.py")) == set()
