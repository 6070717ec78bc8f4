"""The port's kernel plain versions against the reference's Pallas kernels
(interpret mode on CPU), on ragged shapes, at the reference's kernel
tolerance (rtol = atol = 2e-4, ``tests/test_kernels.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.grouped_sumvec import kernel as rg  # noqa: E402
from repro.kernels.sumvec_fft import kernel as rf  # noqa: E402
from repro_torch.kernels.grouped_sumvec import kernel as tg  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pk  # noqa: E402
from repro_torch.kernels.sumvec_fft import kernel as tf  # noqa: E402
from repro_torch.kernels.xcorr_offdiag import kernel as xk  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# ragged shapes, and the four-step plans' widths: N = 32 (real A, stage 1
# at d = 2048), 48 (d = 2304) and 64 (stage 3 at d = 2048)
@pytest.mark.parametrize(
    "m,k,n,real_a",
    [(13, 7, 5, False), (40, 33, 130, False), (21, 9, 11, True), (24, 32, 32, True), (16, 48, 48, False),
     (12, 64, 64, False)],
)
def test_cmatmul_plain_matches_reference(m, k, n, real_a):
    ar, ai, br, bi = _arrays(m + k + n, (m, k), (m, k), (k, n), (k, n))
    if real_a:
        ai = np.zeros_like(ar)
    want = rf._cmatmul_raw(*(jnp.asarray(x) for x in (ar, ai, br, bi)))
    tar, tai, tbr, tbi = _t(ar, ai, br, bi)
    got = tf.cmatmul(tar, None if real_a else tai, tbr, tbi)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("n,d", [(5, 37), (17, 130)])
def test_ctwiddle_plain_matches_reference(n, d):
    xr, xi, wr, wi = _arrays(n * d, (n, d), (n, d), (d,), (d,))
    want = rf._ctwiddle_raw(*(jnp.asarray(x) for x in (xr, xi, wr, wi)))
    got = tf.ctwiddle(*_t(xr, xi, wr, wi))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("m,k,n", [(13, 7, 5), (70, 130, 9)])
def test_pmatmul_plain_matches_reference(m, k, n):
    a, b = _arrays(m * k * n, (m, k), (k, n))
    want = rg._pmatmul_raw(jnp.asarray(a), jnp.asarray(b))
    got = tg.pmatmul(*_t(a, b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# N = 1 and 9 (the kernel's scalar paths), N past one 64-wide output tile
# against a narrow NB
@pytest.mark.parametrize("f,k,n,nb", [(3, 11, 5, 7), (2, 20, 16, 16), (2, 13, 1, 1), (2, 20, 9, 9), (2, 10, 70, 9)])
def test_freq_outer_plain_matches_reference(f, k, n, nb):
    a, b = _arrays(f * k * n, (f, k, n), (f, k, nb))
    want = rg._freq_outer_raw(jnp.asarray(a), jnp.asarray(b))
    got = tg.freq_outer(*_t(a, b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# N = N2 = 16 (d = 2048, b = 128), N = N2 = 64 (d = 8192) at a small K, and
# ragged shapes
@pytest.mark.parametrize("f,k,n,n2", [(3, 11, 5, 7), (2, 20, 16, 16), (2, 8, 64, 64), (2, 70, 130, 9)])
def test_freq_mat_plain_matches_reference(f, k, n, n2):
    a, m = _arrays(f * k + n2, (f, k, n), (f, n, n2))
    want = rg._freq_mat_raw(jnp.asarray(a), jnp.asarray(m))
    got = tg.freq_mat(*_t(a, m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "call",
    [
        lambda: tf.cmatmul(torch.ones(2, 3), None, torch.ones(3, 2), torch.ones(3, 2, device="meta")),
        lambda: tg.pmatmul(torch.ones(2, 3), torch.ones(4, 2)),
        lambda: tg.freq_outer(torch.ones(2, 3, 4), torch.ones(2, 5, 4)),
    ],
    ids=["mixed-devices", "pmatmul-inner-dims", "freq_outer-batch-dims"],
)
def test_wrappers_reject_bad_operands(call):
    with pytest.raises(ValueError):
        call()


def test_cpu_route_never_counts_a_launch():
    from repro_torch import kernels

    kernels.reset_launch_counts()
    tf.cmatmul(torch.ones(4, 3), None, torch.ones(3, 2), torch.ones(3, 2))
    tf.ctwiddle(torch.ones(2, 3), torch.ones(2, 3), torch.ones(3), torch.ones(3))
    tg.pmatmul(torch.ones(2, 3), torch.ones(3, 2))
    tg.freq_outer(torch.ones(2, 3, 4), torch.ones(2, 3, 4))
    tg.freq_mat(torch.ones(2, 3, 4), torch.ones(2, 4, 5))
    xk.off_diagonal_sq_sum_raw(torch.ones(3, 4), torch.ones(3, 4))
    pk.paged_decode_attention(
        torch.ones(2, 4, 8), torch.ones(3, 4, 2, 8), torch.ones(3, 4, 2, 8),
        torch.ones(2, 2, dtype=torch.int32), torch.full((2,), 5, dtype=torch.int32), scale=0.5,
    )
    zeros = {"cmatmul": 0, "ctwiddle": 0, "pmatmul": 0, "freq_outer": 0, "freq_mat": 0, "xcorr_offdiag": 0,
             "paged_attention": 0}
    assert kernels.launch_counts() == zeros
    assert kernels.backward_launch_counts() == zeros


@pytest.fixture
def fake_cuda(monkeypatch):
    """A stand-in CUDA runtime for ``build.launch``: ``current`` device,
    raw stream 1000 + device index, and a record of the device guards
    entered."""
    import contextlib

    state = {"current": 0, "guards": []}

    @contextlib.contextmanager
    def device(index):
        state["guards"].append(index)
        yield

    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["current"])
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index, raising=False)
    monkeypatch.setattr(torch.cuda, "device", device)
    return state


@pytest.mark.parametrize("index,current", [(0, 0), (None, 1), (1, 0)], ids=["current", "unindexed", "other"])
def test_launch_passes_pointers_and_the_current_stream(monkeypatch, fake_cuda, index, current):
    """``build.launch`` hands the C function each tensor's data pointer,
    None and ints as they are, and the raw current stream of the operands'
    device; it enters a device guard only for a device that is not current."""
    from repro_torch.kernels import build

    calls = []
    monkeypatch.setitem(build._FNS, ("fam", "k"), lambda *args: calls.append(args) or 0)
    fake_cuda["current"] = current
    x = torch.ones(3)
    build.launch("fam", "k", torch.device("cuda", index), x, None, 7)
    want = current if index is None else index
    assert calls == [(x.data_ptr(), None, 7, 1000 + want)]
    assert fake_cuda["guards"] == ([] if want == current else [want])


def test_launch_raises_on_a_failed_launch(monkeypatch, fake_cuda):
    import types

    from repro_torch.kernels import build

    monkeypatch.setitem(build._FNS, ("fam", "k"), lambda *args: 9)
    monkeypatch.setattr(build, "library", lambda fam: types.SimpleNamespace(fam_error_string=lambda code: b"refused"))
    with pytest.raises(RuntimeError, match=r"k: CUDA launch failed \(9\): refused"):
        build.launch("fam", "k", torch.device("cuda", 0), torch.ones(2))


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, path.parent


def test_profiler_attribution_names_every_global_function():
    """``chip_smoke.DEVICE_KERNELS`` lists every ``__global__`` function of
    the CUDA sources, each under a kernel whose source holds it, so a
    profiled window counts all of a kernel's passes (xcorr_offdiag's tile
    pass and partials sum, paged_attention's decode and combine)."""
    import re

    cs, root = _chip_smoke()
    found = {}
    for src in sorted((root / "src/repro_torch/kernels/csrc").glob("*.cu")):
        pattern = r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\("
        for name in re.findall(pattern, src.read_text()):
            found[name] = src.name
    listed = {sym: k for k, syms in cs.DEVICE_KERNELS.items() for sym in syms}
    assert sorted(listed) == sorted(found)
    assert set(cs.DEVICE_KERNELS) == set(cs.REPLACES)
    for sym, kernel in listed.items():
        assert cs.SOURCES[kernel].endswith("/" + found[sym]), (sym, kernel)
    assert cs.kernel_of("void (anonymous namespace)::xcorr_tile_kernel<true>(float const*, float const*, float*, "
                        "int, int)") == "xcorr_offdiag"
    assert cs.kernel_of("(anonymous namespace)::sum_partials_kernel(float const*, int, float*)") == "xcorr_offdiag"
    assert cs.kernel_of("void (anonymous namespace)::paged_combine_kernel(float const*, float*, int, int, int, "
                        "int)") == "paged_attention"
    assert cs.kernel_of("void (anonymous namespace)::pmatmul_kernel<4, 4>(float const*)") == "pmatmul"
    assert cs.kernel_of("void (anonymous namespace)::freq_outer_kernel<true, true>(float const*)") == "freq_outer"
    assert cs.kernel_of("(anonymous namespace)::freq_outer_staged_kernel(float const*, CUtensorMap_st)") == "freq_outer"
    assert cs.kernel_of("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>") is None
