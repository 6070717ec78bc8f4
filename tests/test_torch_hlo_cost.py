"""The port's op-level cost analyzer (``repro_torch.launch.hlo_cost``) on the CPU.

* Twins of ``tests/test_hlo_cost.py``: a (64, 32) @ (32, 48) product counts
  exactly 2 m k n; a Python loop of 13 products counts 13x; nested 4 x 6
  loops multiply (eager dispatches every trip: ``trip_counts`` stays {});
  the roofline terms' structure.
* FFTs at 5 N log2 N a transform; the byte rules (views 0, a gather 2x its
  result, ``index_put_`` 2x the update); all-reduce 2x and all-gather 1x
  under a ``fake`` process group; ``roofline_terms`` prices each dtype at
  its own peak; the memory fields.
* Parity with the reference: the port's matrix-product FLOPs against
  ``repro.launch.hlo_cost.analyze_hlo``'s dot FLOPs on the same one-device
  program (reduced gemma2-2b and codeqwen1.5-7b: a 16-token prefill with
  the LM head on every row, as the reference's prefill computes it, and
  one decode step within 2 %, the train step with remat on both sides
  within 5 %).  Bytes are not compared (XLA fuses); the MoE archs dispatch
  by other means (the reference's one-hot einsums are dots), so their
  ratios are printed, not gated.
* Fake CUDA tensors (forward only: a backward pass on them aborts the
  process on a CPU build): each of the seven kernels is charged its C
  entry's FLOPs and its operands' bytes, one launch each, and nothing is
  built or counted by the launch counters.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch.hlo_cost import analyze_hlo  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.models.transformer import init_caches as ref_init_caches  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import warmup_cosine as ref_warmup_cosine  # noqa: E402
from repro.train import create_train_state as ref_create_state  # noqa: E402
from repro.train import make_train_step as ref_make_step  # noqa: E402
from repro.train.serve import make_decode_step as ref_decode_step  # noqa: E402
from repro.train.serve import make_prefill_step as ref_prefill_step  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import hlo_cost as H  # noqa: E402
from repro_torch.models import ParamTree, forward, init_params  # noqa: E402
from repro_torch.models.transformer import init_caches  # noqa: E402
from repro_torch.optim import adamw, warmup_cosine  # noqa: E402
from repro_torch.train import create_train_state, make_train_step  # noqa: E402
from repro_torch.train.serve import make_decode_step, make_prefill_step  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: xdist workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(*shape):
    return torch.from_numpy(np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32))


# ---------------------------------------------------------------------------
# twins of tests/test_hlo_cost.py
# ---------------------------------------------------------------------------


def test_plain_matmul_flops_exact():
    m, k, n = 64, 32, 48
    a = H.analyze(lambda a, b: a @ b, _rand(m, k), _rand(k, n))
    assert a.flops == 2.0 * m * k * n
    assert a.flops_by_op == {"aten.mm": 2.0 * m * k * n} and a.flops_by_dtype == {"float32": 2.0 * m * k * n}
    assert a.trip_counts == {} and a.kernel_launches == {}


def test_loop_flops_scaled_by_trip_count():
    trips, m = 13, 32

    def f(x, ws):
        for i in range(trips):
            x = torch.tanh(x @ ws[i])
        return x

    a = H.analyze(f, _rand(m, m), _rand(trips, m, m))
    assert a.flops == trips * 2.0 * m**3  # every trip dispatched: exact
    assert a.trip_counts == {}


def test_nested_loops_multiply():
    t1, t2, m = 4, 6, 16

    def f(x, ws):
        for i in range(t1):
            for j in range(t2):
                x = x @ ws[i, j]
        return x

    a = H.analyze(f, _rand(m, m), _rand(t1, t2, m, m))
    assert a.flops == t1 * t2 * 2.0 * m**3


def test_grad_counts_fwd_and_bwd():
    trips, m = 8, 16
    x = _rand(m, m)
    ws = _rand(trips, m, m).requires_grad_()

    def f(x, ws):
        y = x
        for i in range(trips):
            y = torch.tanh(y @ ws[i])
        return torch.autograd.grad(y.sum(), ws)[0]

    a = H.analyze(f, x, ws)
    fwd = trips * 2.0 * m**3
    # forward, plus dW every trip and dX on all but the first (x needs no gradient)
    assert a.flops == fwd + trips * 2.0 * m**3 + (trips - 1) * 2.0 * m**3


def test_roofline_terms_structure():
    a = H.analyze(lambda a, b: a @ b, _rand(256, 256), _rand(256, 256))
    t = H.roofline_terms(a)
    assert set(t) >= {"compute_s", "memory_s", "collective_s", "dominant", "bound_s"}
    assert t["dominant"] in ("compute", "memory", "collective")
    assert t["bound_s"] == max(t["compute_s"], t["memory_s"], t["collective_s"])
    assert t["collective_s"] == 0.0  # single device
    assert t["compute_s"] == pytest.approx(2.0 * 256**3 / 67e12)
    assert t["memory_s"] == pytest.approx(3 * 256 * 256 * 4 / 3.35e12)


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,rows", [(64, 8), (100, 3)])
def test_fft_counts_5n_log2n(n, rows):
    x = _rand(rows, n)
    a = H.analyze(lambda x: torch.fft.rfft(x, dim=-1), x)
    assert a.flops_by_op == {"aten._fft_r2c": 5.0 * rows * n * math.log2(n)}
    g = H.analyze(lambda x: torch.fft.irfft(torch.fft.rfft(x, dim=-1), n=n, dim=-1), x)
    assert g.flops == pytest.approx(2 * 5.0 * rows * n * math.log2(n))
    assert set(g.flops_by_op) == {"aten._fft_r2c", "aten._fft_c2r"}


def test_views_move_no_bytes():
    a = H.analyze(lambda x: x.view(4, 128).t().unsqueeze(0).expand(3, 128, 4)[1, 2:], _rand(8, 64))
    assert a.hbm_bytes == 0.0 and a.flops == 0.0 and a.n_ops >= 4


def test_gather_costs_twice_its_result():
    x, idx = _rand(8, 64), torch.tensor([1, 3, 5])
    a = H.analyze(lambda x, i: x[i], x, idx)
    assert a.hbm_bytes == 2.0 * 3 * 64 * 4
    e = H.analyze(lambda x, i: torch.index_select(x, 0, i), x, idx)
    assert e.hbm_bytes == 2.0 * 3 * 64 * 4


def test_index_put_costs_twice_the_update():
    x, idx, v = _rand(8, 64), torch.tensor([1, 3, 5]), _rand(3, 64)

    def put(x, i, v):
        x.index_put_((i,), v)
        return x

    a = H.analyze(put, x, idx, v)
    assert a.hbm_bytes == 2.0 * 3 * 64 * 4
    assert torch.equal(x, _rand(8, 64))  # the caller's tensor is untouched


def test_elementwise_bytes_and_memory_fields():
    x = _rand(32, 32)
    a = H.analyze(lambda x: (x * 2.0) + x, x)
    nb = 32 * 32 * 4
    # mul: read x, write t; add: read t and x, write the result
    assert a.hbm_bytes == (nb + nb) + (nb + 2 * nb)
    assert a.argument_bytes == nb and a.output_bytes == nb and a.alias_bytes == 0
    assert a.temp_bytes == 2 * nb  # the temporary and the result alive at once
    assert a.peak_bytes == 3 * nb

    def inplace(x):
        x.mul_(2.0)
        return x

    b = H.analyze(inplace, x)
    assert b.alias_bytes == nb and b.output_bytes == 0 and b.temp_bytes == 0


def test_roofline_prices_each_dtype_at_its_peak():
    a = H.OpAnalysis(flops=3e12, hbm_bytes=0.0, collective_bytes={}, flops_by_op={}, trip_counts={}, n_ops=0,
                     flops_by_dtype={"bfloat16": 989e12, "float32": 67e12})
    t = H.roofline_terms(a)
    assert t["compute_s"] == pytest.approx(2.0) and t["dominant"] == "compute"
    b = H.analyze(lambda a, b: a @ b, _rand(64, 64).bfloat16(), _rand(64, 64).bfloat16())
    assert b.flops_by_dtype == {"bfloat16": 2.0 * 64**3}
    assert H.roofline_terms(b)["compute_s"] == pytest.approx(2.0 * 64**3 / 989e12)
    c = H.OpAnalysis(flops=0.0, hbm_bytes=0.0, collective_bytes={"all-reduce": 450e9}, flops_by_op={},
                     trip_counts={}, n_ops=0)
    assert H.roofline_terms(c)["collective_s"] == pytest.approx(1.0)


def test_real_arguments_untouched_and_device_free():
    """The analysis runs on fake copies: an in-place update of a parameter
    leaves the real one as it was."""
    model = ParamTree({"w": _rand(4, 4)})
    before = model.w.detach().clone()

    def step(m):
        with torch.no_grad():
            m.w.add_(1.0)
        return m

    H.analyze(step, model)
    assert torch.equal(model.w.detach(), before)


COLLECTIVES = r"""
import json, torch, torch.distributed as dist
import torch.distributed._functional_collectives as fc
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import hlo_cost as H
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
def f(x):
    dist.all_reduce(x)
    out = torch.empty(8 * x.shape[0], x.shape[1])
    dist.all_gather_into_tensor(out, x)
    y = fc.all_reduce(x, "sum", dist.group.WORLD)
    return out, y
a = H.analyze(f, torch.ones(4, 16))
print(json.dumps(a.collective_bytes))
dist.destroy_process_group()
"""


def test_collectives_ring_factors_under_a_fake_group():
    """c10d and functional collectives: all-reduce 2x its result, all-gather
    1x (in a subprocess: the fake group stays out of this worker)."""
    import json
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    out = subprocess.run([sys.executable, "-c", COLLECTIVES], env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    coll = json.loads(out.stdout.strip().splitlines()[-1])
    nb = 4 * 16 * 4
    assert coll["all-reduce"] == 2.0 * nb * 2  # c10d and functional, each 2x
    assert coll["all-gather"] == 8 * nb
    assert coll["reduce-scatter"] == coll["all-to-all"] == coll["collective-permute"] == 0.0


# ---------------------------------------------------------------------------
# parity with the reference's analyze_hlo
# ---------------------------------------------------------------------------


def _ref_dot_flops(fn, *args) -> float:
    a = analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())
    return float(sum(a.dot_flops_by_meta.values()))


def _ref_tree(rcfg):
    return ref_init(jax.random.PRNGKey(0), rcfg)


PREFILL, BATCH = 16, 2


def _serve_flops(arch):
    """(port, reference) product FLOPs of a 16-token prefill and one decode step."""
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    rparams = _ref_tree(rcfg)
    rcaches = ref_init_caches(rcfg, BATCH, 32)
    toks = jnp.zeros((BATCH, PREFILL), jnp.int32)
    ref_pre = _ref_dot_flops(ref_prefill_step(rcfg), rparams, rcaches, toks)
    ref_dec = _ref_dot_flops(ref_decode_step(rcfg), rparams, rcaches, jnp.int32(PREFILL),
                             jnp.zeros((BATCH, 1), jnp.int32))
    params, caches = init_params(cfg, device="cpu"), init_caches(cfg, BATCH, 32, device="cpu")
    ptoks = torch.zeros((BATCH, PREFILL), dtype=torch.int32)
    # the reference's prefill runs the LM head on every row and slices the
    # last: the same program is the port's forward with its head on every row
    # (the port's serving prefill heads the last row only; its ratio is printed)
    pre = H.analyze(torch.no_grad()(lambda p, c, t: forward(p, cfg, t, caches=c, cache_len=0)), params, caches, ptoks)
    served = H.analyze(torch.no_grad()(make_prefill_step(cfg)), params, caches, ptoks)
    print(f"{arch} serving prefill (last row's head) / reference prefill: {served.product_flops / ref_pre:.4f}")
    dec = H.analyze(torch.no_grad()(make_decode_step(cfg)), params, caches, PREFILL,
                    torch.zeros((BATCH, 1), dtype=torch.int32))
    return (pre.product_flops, ref_pre), (dec.product_flops, ref_dec)


def _train_flops(arch):
    """(port, reference) product FLOPs of one train step, remat on both sides."""
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    assert rcfg.remat and cfg.remat
    tokens = np.zeros((BATCH, 32), np.int32)
    rstate = ref_create_state(_ref_tree(rcfg), ref_adamw())
    rbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    ref = _ref_dot_flops(ref_make_step(rcfg, ref_adamw(), ref_warmup_cosine(3e-3, 0, 10)), rstate, rbatch)
    opt = adamw()
    state = create_train_state(ParamTree(init_params(cfg, device="cpu")), opt)
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(tokens)}
    a = H.analyze(make_train_step(cfg, opt, warmup_cosine(3e-3, 0, 10)), state, batch)
    assert state.step == 0  # the analysis stepped a fake copy
    return a.product_flops, ref


@pytest.mark.parametrize("arch", ["gemma2-2b", "codeqwen1.5-7b"])
def test_serving_product_flops_match_the_reference(arch):
    (pre, ref_pre), (dec, ref_dec) = _serve_flops(arch)
    print(f"{arch} prefill {pre:.6g} / {ref_pre:.6g} = {pre / ref_pre:.4f}; decode {dec:.6g} / {ref_dec:.6g} = "
          f"{dec / ref_dec:.4f}")
    assert pre == pytest.approx(ref_pre, rel=0.02)
    assert dec == pytest.approx(ref_dec, rel=0.02)


@pytest.mark.parametrize("arch", ["gemma2-2b", "codeqwen1.5-7b"])
def test_train_step_product_flops_match_the_reference(arch):
    got, ref = _train_flops(arch)
    print(f"{arch} train step (remat) {got:.6g} / {ref:.6g} = {got / ref:.4f}")
    assert got == pytest.approx(ref, rel=0.05)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "arctic-480b"])
def test_moe_product_flops_ratio_printed(arch):
    """The MoE archs' dispatch differs by design (the reference's one-hot
    einsums are dots, the port scatters): the ratio is reported, and both
    sides count something."""
    (pre, ref_pre), (dec, ref_dec) = _serve_flops(arch)
    got, ref = _train_flops(arch)
    print(f"{arch} ratios port / reference: prefill {pre / ref_pre:.4f} decode {dec / ref_dec:.4f} "
          f"train {got / ref:.4f}")
    assert min(pre, ref_pre, dec, ref_dec, got, ref) > 0


# ---------------------------------------------------------------------------
# kernels on fake CUDA tensors (forward only)
# ---------------------------------------------------------------------------


def _fake_cuda(mode, *specs):
    with mode:
        return [None if s is None else torch.empty(s[0], dtype=s[1] if len(s) > 1 else torch.float32,
                                                  device="cuda") for s in specs]


def _kernel_cases():
    from repro_torch.kernels.grouped_sumvec import kernel as gk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.sumvec_fft import kernel as fk
    from repro_torch.kernels.xcorr_offdiag import kernel as xk

    f4 = 4
    m, k, n = 64, 16, 8
    b, h, kv, hd, page, pages, nb = 2, 8, 4, 64, 16, 10, 3
    i32 = torch.int32
    return [
        ("cmatmul", lambda a, ai, br, bi: fk.cmatmul(a, ai, br, bi), [((m, k),), ((m, k),), ((k, n),), ((k, n),)],
         8.0 * m * k * n, f4 * (2 * m * k + 2 * k * n + 2 * m * n)),
        ("cmatmul", lambda a, br, bi: fk.cmatmul(a, None, br, bi), [((m, k),), ((k, n),), ((k, n),)],
         4.0 * m * k * n, f4 * (m * k + 2 * k * n + 2 * m * n)),
        ("ctwiddle", fk.ctwiddle, [((m, k),), ((m, k),), ((k,),), ((k,),)], 6.0 * m * k,
         f4 * (4 * m * k + 2 * k)),
        ("pmatmul", gk.pmatmul, [((m, k),), ((k, n),)], 2.0 * m * k * n, f4 * (m * k + k * n + m * n)),
        ("freq_outer", gk.freq_outer, [((5, m, k),), ((5, m, n),)], 2.0 * 5 * m * k * n,
         f4 * 5 * (m * k + m * n + k * n)),
        ("freq_mat", gk.freq_mat, [((5, m, k),), ((5, k, n),)], 2.0 * 5 * m * k * n,
         f4 * 5 * (m * k + k * n + m * n)),
        ("xcorr_offdiag", xk.off_diagonal_sq_sum_raw, [((m, 200),), ((m, 200),)], 2.0 * m * 200 * 200,
         # + the wrapper's zeroed output (one op writing 4 bytes)
         f4 * (2 * m * 200 + (-(-200 // xk.TILE)) ** 2 + 1) + 4),
        ("paged_attention", lambda q, kp, vp, bt, lens: pk.paged_decode_attention(q, kp, vp, bt, lens, scale=0.1),
         [((b, h, hd),), ((pages, page, kv, hd), torch.bfloat16), ((pages, page, kv, hd), torch.bfloat16),
          ((b, nb), i32), ((b,), i32)],
         4.0 * b * h * nb * page * hd,
         f4 * 2 * b * h * hd + 2 * b * nb * page * kv * hd * 2 + 4 * (b * nb + b)),
    ]


@pytest.mark.parametrize("case", range(8))
def test_fake_cuda_kernels_charge_their_c_entry(case, monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    name, fn, specs, flops, nbytes = _kernel_cases()[case]
    built = []
    monkeypatch.setattr(build, "build_all", lambda: built.append(1))
    monkeypatch.setattr(build, "_function", lambda *a: built.append(1))
    kernels.reset_launch_counts()
    args = _fake_cuda(FakeTensorMode(allow_non_fake_inputs=True), *specs)
    a = H.analyze(fn, *args)
    assert a.kernel_launches == {name: 1}
    assert a.flops_by_op == {f"kernel.{name}": flops}
    assert a.hbm_bytes == pytest.approx(nbytes)
    assert built == [] and not any(kernels.launch_counts().values())
