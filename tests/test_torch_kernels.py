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
from repro_torch.kernels.sumvec_fft import kernel as tf  # noqa: E402
from repro_torch.kernels.xcorr_offdiag import kernel as xk  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("m,k,n,real_a", [(13, 7, 5, False), (40, 33, 130, False), (21, 9, 11, True)])
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


@pytest.mark.parametrize("f,k,n,nb", [(3, 11, 5, 7), (2, 20, 16, 16)])
def test_freq_outer_plain_matches_reference(f, k, n, nb):
    a, b = _arrays(f * k * n, (f, k, n), (f, k, nb))
    want = rg._freq_outer_raw(jnp.asarray(a), jnp.asarray(b))
    got = tg.freq_outer(*_t(a, b))
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
    zeros = {"cmatmul": 0, "ctwiddle": 0, "pmatmul": 0, "freq_outer": 0, "freq_mat": 0, "xcorr_offdiag": 0}
    assert kernels.launch_counts() == zeros
    assert kernels.backward_launch_counts() == zeros
