"""Op-level cost analyzer — the port's roofline inputs (port of
``repro/launch/hlo_cost.py``).

The reference parses XLA's optimized HLO.  Eager PyTorch has no compiler
and no HLO, so this module parses nothing: ``analyze`` replaces
``analyze_hlo`` (``repro/launch/hlo_cost.py:164``) by RECORDING the ops a
call dispatches.  It runs the callable on fake copies of its arguments
(``FakeTensorMode``: shapes and dtypes, no memory) under a
``TorchDispatchMode`` that sees every aten op, every c10d / functional
collective and, through ``kernels/build.launch``, every hand-written kernel
launch — so an analysis touches no device memory and leaves the caller's
tensors as they were.  What it sums, per call (per rank: the program a rank
runs):

  * flops — matrix products and convolutions by ``torch.utils.flop_counter``'s
    per-op formulas, FFTs (``_fft_r2c`` / ``_fft_c2c`` / ``_fft_c2r``) at
    5 N log2 N a transform, each kernel by its C entry's formula (the one
    ``tune/cost.analytic_cost`` ranks by); elementwise work counts 0, as
    in the reference.  Split by dtype (``flops_by_dtype``, each dtype
    priced at its own peak) and by op (``flops_by_op``, the counterpart of
    ``dot_flops_by_meta``);
  * hbm_bytes — result plus distinct operand bytes of every op; 0 for views
    and aliases (the counterpart of ``_SKIP_BYTES_OPS``); 2 x the result for
    a gather (``index_select``, ``gather``, ``index``, ``embedding``); 2 x
    the update for a scatter (``index_put_``, ``scatter``, ``index_copy_``,
    ``index_add_``, ``copy_``); a kernel's tensor operands each read or
    written once (PERF.md's bound rule; paged attention: the page rows its
    block tables can reach, since the live lengths are data).  No fusion:
    eager runs each op as its own kernel, so the sum is the traffic model
    the reference calls an upper bound;
  * collective_bytes — c10d and functional collectives by result bytes,
    with the reference's ring factors (all-reduce 2x, the rest 1x);
  * memory — ``argument_bytes`` (the distinct storages of the arguments),
    ``output_bytes`` / ``alias_bytes`` (result storages made by the call /
    that are arguments', e.g. a train state updated in place) and
    ``temp_bytes``: the high-water mark of the bytes alive that the call
    created (storages tracked with ``weakref.finalize``).  Peak memory of a
    call is ``argument_bytes + temp_bytes``;
  * kernel_launches — launches by kernel name (the launch counters' names).

Eager loops dispatch every trip, so every count is trip-exact by
construction and ``trip_counts`` stays ``{}``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import threading
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import build

Tensor = torch.Tensor

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
# ring-model traffic factor applied to the RESULT size
_COLL_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
# op name fragments (c10d and _c10d_functional) -> collective kind
_COLL_KINDS = (
    ("reduce_scatter", "reduce-scatter"), ("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
    ("allgather", "all-gather"), ("all_gather", "all-gather"), ("alltoall", "all-to-all"),
    ("all_to_all", "all-to-all"), ("broadcast", "collective-permute"), ("send", "collective-permute"),
    ("recv", "collective-permute"),
)

# views, aliases and metadata: no bytes move
_SKIP_BYTES_OPS = {
    "view", "_unsafe_view", "t", "expand", "slice", "select", "as_strided", "detach", "alias",
    "permute", "transpose", "unsqueeze", "squeeze", "reshape", "unfold", "diagonal", "split",
    "split_with_sizes", "chunk", "unbind", "narrow", "view_as_real", "view_as_complex", "_reshape_alias",
    "lift_fresh", "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_to_copy_noop", "set_", "resize_", "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "_has_compatible_shallow_copy_type", "wait_tensor",
}
_GATHER_OPS = {"index_select", "gather", "index", "embedding"}
# scatters: (update operand position)
_SCATTER_OPS = {"index_put_": 2, "index_put": 2, "_index_put_impl_": 2, "scatter": 3, "scatter_": 3,
                "scatter_add": 3, "scatter_add_": 3, "index_copy_": 3, "index_copy": 3,
                "index_add_": 3, "index_add": 3, "copy_": 1}
_FFT_OPS = ("_fft_r2c", "_fft_c2c", "_fft_c2r")
_PRODUCT_OPS = ("mm", "bmm", "addmm", "baddbmm", "convolution", "convolution_backward", "_convolution")

# the launch counters' names (kernels.launch_counts) of each C entry
KERNEL_NAMES = {
    ("sumvec_fft", "cmatmul"): "cmatmul",
    ("sumvec_fft", "ctwiddle"): "ctwiddle",
    ("grouped_sumvec", "pmatmul"): "pmatmul",
    ("grouped_sumvec", "freq_outer"): "freq_outer",
    ("grouped_sumvec", "freq_mat"): "freq_mat",
    ("xcorr_offdiag", "off_diagonal_sq_sum"): "xcorr_offdiag",
    ("paged_attention", "decode"): "paged_attention",
}


@dataclasses.dataclass
class OpAnalysis:
    """The reference's ``HLOAnalysis`` fields, plus the dtype split, the
    kernel launches and the call's memory."""

    flops: float
    hbm_bytes: float
    collective_bytes: Dict[str, float]
    flops_by_op: Dict[str, float]
    trip_counts: Dict[str, int]
    n_ops: int
    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    temp_bytes: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    @property
    def product_flops(self) -> float:
        """FLOPs of the matrix products and convolutions alone (what the
        reference's ``dot_flops_by_meta`` sums)."""
        return sum(f for op, f in self.flops_by_op.items() if op.split(".")[-1] in _PRODUCT_OPS)

    @property
    def peak_bytes(self) -> int:
        """Arguments plus the call's high-water mark of its own storages."""
        return self.argument_bytes + self.temp_bytes


# ---------------------------------------------------------------------------
# Roofline terms (H100 SXM data sheet)
# ---------------------------------------------------------------------------

# dense tensor-core bf16 / fp16, and f32 without tensor cores (the port keeps
# TF32 off: ``resolve_device``)
PEAK_FLOPS_BY_DTYPE = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_FLOPS = PEAK_FLOPS_BY_DTYPE["float32"]
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s each way


def peak_flops(dtype: str) -> float:
    """The card's peak for ``dtype``'s FLOPs (f32's for any other type:
    complex FFTs, f64, integers)."""
    return PEAK_FLOPS_BY_DTYPE.get(dtype, PEAK_FLOPS)


def roofline_terms(analysis: OpAnalysis) -> Dict[str, Any]:
    """compute_s (each dtype's FLOPs over its own peak), memory_s, collective_s,
    the dominant term and the bound (their max)."""
    by_dtype = analysis.flops_by_dtype or {"float32": analysis.flops}
    t_compute = sum(f / peak_flops(dt) for dt, f in by_dtype.items())
    t_memory = analysis.hbm_bytes / HBM_BW
    t_coll = analysis.total_collective_bytes / NVLINK_BW
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
        "dominant": dominant,
        "bound_s": max(t_compute, t_memory, t_coll),
    }


# ---------------------------------------------------------------------------
# Fake copies of the arguments
# ---------------------------------------------------------------------------


class _FakeCopier:
    """Fake copies of tensors inside dicts, lists, tuples, dataclasses
    (``TrainState``), modules (``ParamTree``, any ``nn.Module``) and
    optimizers, one fake per real tensor (shared storage stays shared).
    A fake tensor passes through; nothing else is copied."""

    def __init__(self, mode: FakeTensorMode):
        self.mode = mode
        self.memo: Dict[int, Any] = {}

    def __call__(self, obj):
        key = id(obj)
        if key in self.memo:
            return self.memo[key]
        out = self._convert(obj)
        self.memo[key] = out
        return out

    def _convert(self, obj):
        if isinstance(obj, FakeTensor):
            return obj
        if isinstance(obj, Tensor):
            return self.mode.from_tensor(obj)
        if isinstance(obj, nn.Module):
            return self._module(obj)
        if isinstance(obj, torch.optim.Optimizer):
            return self._optimizer(obj)
        if isinstance(obj, dict):
            out = copy.copy(obj)
            out.update((k, self(v)) for k, v in obj.items())
            return out
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            return type(obj)(*(self(v) for v in obj))
        if isinstance(obj, (list, tuple)):
            return type(obj)(self(v) for v in obj)
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            changes = {f.name: self(getattr(obj, f.name)) for f in dataclasses.fields(obj) if f.init}
            if all(changes[k] is getattr(obj, k) for k in changes):
                return obj
            return dataclasses.replace(obj, **changes)
        return obj

    def _module(self, m: nn.Module) -> nn.Module:
        new = copy.copy(m)  # a new __dict__; the tensors are replaced below
        self.memo[id(m)] = new
        new._parameters = {k: None if p is None else self(p) for k, p in m._parameters.items()}
        new._buffers = {k: None if b is None else self(b) for k, b in m._buffers.items()}
        new._modules = {k: None if c is None else self(c) for k, c in m._modules.items()}
        return new

    def _optimizer(self, opt: torch.optim.Optimizer) -> torch.optim.Optimizer:
        new = copy.copy(opt)
        self.memo[id(opt)] = new
        new.param_groups = [dict(g, params=[self(p) for p in g["params"]]) for g in opt.param_groups]
        state = defaultdict(dict)
        for p, s in opt.state.items():
            state[self(p)] = {k: self(v) for k, v in s.items()}
        new.state = state
        return new


def _tensors(obj, seen=None):
    """Every tensor reachable through the containers ``_FakeCopier`` walks,
    each once."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, Tensor):
        yield obj
    elif isinstance(obj, nn.Module):
        for t in (*obj.parameters(), *obj.buffers()):
            yield from _tensors(t, seen)
    elif isinstance(obj, torch.optim.Optimizer):
        for s in obj.state.values():
            for v in s.values():
                yield from _tensors(v, seen)
        for g in obj.param_groups:
            yield from _tensors(g["params"], seen)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name), seen)


def _storage_key(t: Tensor) -> int:
    return t.untyped_storage()._cdata


def _storage_bytes(tensors) -> Dict[int, int]:
    out = {}
    for t in tensors:
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------


def _nbytes(t: Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _float_dtype(args) -> str:
    for a in args:
        if isinstance(a, Tensor) and (a.is_floating_point() or a.is_complex()):
            return _dtype_name(a.dtype)
    return "float32"


def _fft_flops(name: str, args, out) -> float:
    """5 N log2 N for each length-N transform over the op's ``dim``s."""
    x, dims = args[0], args[1]
    signal = out if name == "_fft_c2r" else x
    shape = tuple(signal.shape)
    n = 1
    for d in dims:
        n *= shape[d]
    rows = math.prod(shape) // max(n, 1)
    return 5.0 * rows * n * max(math.log2(n), 1.0) if n > 1 else 0.0


def _kernel_cost(family: str, name: str, args) -> Tuple[float, float]:
    """(FLOPs, bytes) of one launch: the C entry's formula, and each tensor
    operand read or written once."""
    tensors = [a for a in args if isinstance(a, Tensor)]
    ints = [a for a in args if isinstance(a, int)]
    nbytes = float(sum(_nbytes(t) for t in tensors))
    if name == "cmatmul":
        _, ai, _, _, _, ci = args[:6]
        m, k, n = ints[:3]
        # real products: Re C = Ar Br - Ai Bi, Im C = Ar Bi + Ai Br (an absent Ai or Ci skips its half)
        products = (1 + (ai is not None)) * (1 + (ci is not None))
        return 2.0 * m * k * n * products, nbytes
    if name == "ctwiddle":
        n, d = ints[:2]
        return 6.0 * n * d, nbytes
    if name == "pmatmul":
        m, k, n = ints[:3]
        return 2.0 * m * k * n, nbytes
    if name == "freq_outer":
        f, k, n, nb = ints[:4]
        return 2.0 * f * k * n * nb, nbytes
    if name == "freq_mat":
        f, k, n, n2 = ints[:4]
        return 2.0 * f * k * n * n2, nbytes
    if name == "off_diagonal_sq_sum":
        n, d = ints[:2]
        return 2.0 * n * d * d, nbytes
    if name == "decode":
        q, k_pages, v_pages = args[:3]
        b, kv, n_rep, hd, page, nb = ints[:6]
        rows = nb * page  # the rows the block tables reach
        pool = _nbytes(k_pages) + _nbytes(v_pages)
        reach = 2.0 * b * rows * kv * hd * k_pages.element_size()
        nbytes = nbytes - pool + min(pool, reach)
        return 4.0 * b * kv * n_rep * rows * hd, nbytes
    raise KeyError(f"no cost formula for kernel {family}.{name}")


# per aten / c10d op: (name, collective kind, FLOP rule, byte rule), worked
# out once per op overload
_RULES: Dict[Any, Tuple[str, Any, Any, Any]] = {}


def _rule(func):
    rule = _RULES.get(func)
    if rule is None:
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        coll = flop = nbytes = None
        if ns in ("c10d", "_c10d_functional", "c10d_functional"):
            coll = next((k for frag, k in _COLL_KINDS if frag in name), None)
        elif ns != "prim":
            flop = "registry" if func._overloadpacket in flop_registry else "fft" if name in _FFT_OPS else None
            nbytes = (None if name in _SKIP_BYTES_OPS or getattr(func, "is_view", False)
                      else "gather" if name in _GATHER_OPS else "scatter" if name in _SCATTER_OPS else "all")
        rule = _RULES[func] = (name, coll, flop, nbytes)
    return rule


class _Recorder(TorchDispatchMode):
    """Sums FLOPs, bytes, collectives, launches and live bytes of every op
    dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.lock = threading.RLock()
        self.flops_by_op: Dict[str, float] = defaultdict(float)
        self.flops_by_dtype: Dict[str, float] = defaultdict(float)
        self.coll = {c: 0.0 for c in _COLLECTIVES}
        self.launches: Dict[str, int] = defaultdict(int)
        self.hbm = 0.0
        self.n_ops = 0
        self.live: Dict[int, int] = {}
        self.known: set = set()  # storages of the arguments
        self.cur = 0
        self.peak = 0

    # -- storages ----------------------------------------------------------
    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live or key in self.known:
                continue
            n = st.nbytes()
            self.live[key] = n
            self.cur += n
            self.peak = max(self.peak, self.cur)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        with self.lock:
            self.cur -= self.live.pop(key, 0)

    # -- kernels (called by kernels/build.launch) ----------------------------
    def record_launch(self, family: str, name: str, args) -> None:
        flops, nbytes = _kernel_cost(family, name, args)
        label = KERNEL_NAMES.get((family, name), f"{family}.{name}")
        with self.lock:
            self.launches[label] += 1
            self.flops_by_op[f"kernel.{label}"] += flops
            self.flops_by_dtype["float32"] += flops
            self.hbm += nbytes

    # -- ops -------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name, coll, flop, nbytes = _rule(func)
        if func.namespace == "prim":
            return out
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, Tensor)]
        with self.lock:
            self.n_ops += 1
            self._track(outs)
            if coll is not None:
                # an op that returns only its work handle (``alltoall_base_``)
                # wrote its result into its first operand
                moved = outs or [a for a in args[:1] if isinstance(a, Tensor)]
                self.coll[coll] += sum(_nbytes(t) for t in moved) * _COLL_FACTOR[coll]
            if flop is None and nbytes is None:
                return out
            flat_args = tree_flatten((args, kwargs))[0]
            if flop is not None:
                f = (float(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)) if flop == "registry"
                     else _fft_flops(name, args, out))
                self.flops_by_op[f"aten.{name}"] += f
                self.flops_by_dtype[_float_dtype(flat_args)] += f
            if nbytes == "gather":
                self.hbm += 2.0 * sum(_nbytes(t) for t in outs)
            elif nbytes == "scatter":
                pos = _SCATTER_OPS[name]
                upd = args[pos] if len(args) > pos else kwargs.get("src", kwargs.get("values"))
                if isinstance(upd, (list, tuple)):  # index_put_'s indices come first
                    upd = args[-1]
                self.hbm += 2.0 * (_nbytes(upd) if isinstance(upd, Tensor) else sum(_nbytes(t) for t in outs))
            elif nbytes == "all":
                seen = set()
                operand = 0
                for a in flat_args:
                    if isinstance(a, Tensor) and id(a) not in seen:
                        seen.add(id(a))
                        operand += _nbytes(a)
                self.hbm += sum(_nbytes(t) for t in outs) + operand
        return out


def extend(first: OpAnalysis, second: OpAnalysis, times: int) -> OpAnalysis:
    """The analysis of a call that runs ``times`` more repeats of a part
    that ``second``'s call runs once more than ``first``'s: each field of
    ``second`` plus ``times`` of its difference from ``first``.  Exact where
    every repeat dispatches the same ops, takes the same argument bytes and
    raises the high-water mark by the same bytes (the microbatches of a
    train step from its third: ``launch/dryrun.analyze_cell``)."""

    def more(a, b):
        return b + times * (b - a)

    def more_each(a: Dict, b: Dict) -> Dict:
        return {k: more(a.get(k, 0), b.get(k, 0)) for k in {**b, **a}}

    return OpAnalysis(
        flops=more(first.flops, second.flops),
        hbm_bytes=more(first.hbm_bytes, second.hbm_bytes),
        collective_bytes=more_each(first.collective_bytes, second.collective_bytes),
        flops_by_op=more_each(first.flops_by_op, second.flops_by_op),
        trip_counts={},
        n_ops=more(first.n_ops, second.n_ops),
        flops_by_dtype=more_each(first.flops_by_dtype, second.flops_by_dtype),
        kernel_launches=more_each(first.kernel_launches, second.kernel_launches),
        argument_bytes=more(first.argument_bytes, second.argument_bytes),
        output_bytes=more(first.output_bytes, second.output_bytes),
        alias_bytes=more(first.alias_bytes, second.alias_bytes),
        temp_bytes=more(first.temp_bytes, second.temp_bytes),
    )


def analyze(fn: Callable, *args, **kw) -> OpAnalysis:
    """Run ``fn(*args, **kw)`` once on fake copies of its arguments (real
    tensors are copied by ``FakeTensorMode.from_tensor``; fake ones are used
    as they are, in their own mode) and return what its ops cost.  Nothing
    is allocated on a device and no argument changes.  A kernel wrapper
    called on a fake CUDA tensor reports its launch and launches nothing;
    on fake CPU tensors the wrappers take their plain route (no launch)."""
    given = [t for t in _tensors((args, kw)) if isinstance(t, FakeTensor)]
    mode = given[0].fake_mode if given else FakeTensorMode(allow_non_fake_inputs=True)
    copier = _FakeCopier(mode)
    fargs, fkw = copier(args), copier(kw)
    arg_storages = _storage_bytes(_tensors((fargs, fkw)))
    rec = _Recorder()
    rec.known = set(arg_storages)
    remove = build.add_recorder(mode, rec.record_launch)
    try:
        with mode, rec:
            result = fn(*fargs, **fkw)
        out_storages = _storage_bytes(_tensors(result))
    finally:
        remove()
    alias = sum(n for k, n in out_storages.items() if k in arg_storages)
    return OpAnalysis(
        flops=float(sum(rec.flops_by_op.values())),
        hbm_bytes=float(rec.hbm),
        collective_bytes=dict(rec.coll),
        flops_by_op=dict(rec.flops_by_op),
        trip_counts={},
        n_ops=rec.n_ops,
        flops_by_dtype=dict(rec.flops_by_dtype),
        kernel_launches=dict(rec.launches),
        argument_bytes=int(sum(arg_storages.values())),
        output_bytes=int(sum(out_storages.values()) - alias),
        alias_bytes=int(alias),
        temp_bytes=int(rec.peak),
    )
