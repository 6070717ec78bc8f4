"""The rest of ``repro.core`` on the port: the paper's O(d^2) building
blocks and oracles (involution, Eq. 7 convolution, Appendix A correlation,
Eq. 10 ``sumvec_direct``, the §4.4 grouped forms), the variance hinge
(Eq. 4), the explicit-C R_sum oracles (Eq. 6 / Eq. 13) and
``choose_factors`` / ``spectrum_ref`` of the four-step kernels.  The
package's exports are pinned by ``tests/test_torch_surface.py``.

Each function is held against its reference twin on the same seeded numpy
inputs (f32: within 1e-5 x max(1, max |want|); ``involution`` and
``choose_factors`` exactly), then the identities the reference's own tests
pin are checked on the port alone, at the reference's bounds
(``tests/test_sumvec.py``, ``tests/test_regularizers.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import regularizers as rregs  # noqa: E402
from repro.core import sumvec as rsv  # noqa: E402
from repro.kernels.sumvec_fft import ops as rfops  # noqa: E402
from repro.kernels.sumvec_fft import ref as rfref  # noqa: E402
from repro_torch.core import regularizers as regs  # noqa: E402
from repro_torch.core import sumvec as sv  # noqa: E402
from repro_torch.core.losses import standardize  # noqa: E402
from repro_torch.kernels.sumvec_fft import ops as fops  # noqa: E402
from repro_torch.kernels.sumvec_fft import ref as fref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (see tests/test_torch_lm_train.py):
    under the parallel test workers torch's default pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arr(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _views(seed, n, d):
    """Two correlated (n, d) views: a shared component plus noise."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, d)).astype(np.float32)
    return base, (0.7 * base + 0.5 * rng.standard_normal((n, d))).astype(np.float32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want):
    """The port against the reference in f32: max |got - want| within
    1e-5 x max(1, max |want|)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = 1e-5 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.complex128) - want.astype(np.complex128)).max())
    assert err <= bound, (err, bound)


# ---------------------------------------------------------------------------
# each function against its reference twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7,), (3, 8), (2, 4, 5)])
def test_involution_equals_the_reference(shape):
    x = _arr(0, *shape)
    np.testing.assert_array_equal(sv.involution(torch.from_numpy(x)).numpy(), np.asarray(rsv.involution(x)))


@pytest.mark.parametrize("fn", ["circular_convolve", "circular_correlate_naive"])
@pytest.mark.parametrize("shape", [(16,), (12, 13)])
def test_naive_circular_ops_match_the_reference(fn, shape):
    x, y = _arr(1, *shape), _arr(2, *shape)
    _close(getattr(sv, fn)(torch.from_numpy(x), torch.from_numpy(y)), getattr(rsv, fn)(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("d,scale", [(16, None), (13, 7.0)])
def test_sumvec_direct_matches_the_reference(d, scale):
    z1, z2 = _views(3, 12, d)
    _close(sv.sumvec_direct(torch.from_numpy(z1), torch.from_numpy(z2), scale=scale),
           rsv.sumvec_direct(jnp.asarray(z1), jnp.asarray(z2), scale=scale))


def test_sumvec_direct_sums_chunks_of_samples(monkeypatch):
    """Five samples a chunk over twelve (a ragged last chunk): the same sum."""
    z1, z2 = _views(4, 12, 13)
    want = rsv.sumvec_direct(jnp.asarray(z1), jnp.asarray(z2))
    monkeypatch.setattr(sv, "_DIRECT_CHUNK_ELEMS", 5 * 13 * 13)
    _close(sv.sumvec_direct(torch.from_numpy(z1), torch.from_numpy(z2)), want)


@pytest.mark.parametrize("d,b,scale", [(16, 4, None), (13, 4, 12.0), (13, 16, None)],
                         ids=["even", "ragged", "b-over-d"])
def test_grouped_sumvec_fft_matches_the_reference(d, b, scale):
    z1, z2 = _views(7, 12, d)
    _close(sv.grouped_sumvec_fft(torch.from_numpy(z1), torch.from_numpy(z2), b, scale=scale),
           rsv.grouped_sumvec_fft(jnp.asarray(z1), jnp.asarray(z2), b, scale=scale))


@pytest.mark.parametrize("d,b", [(16, 4), (13, 4), (13, 16)], ids=["even", "ragged", "b-over-d"])
def test_grouped_sumvec_from_matrix_matches_the_reference(d, b):
    c = _arr(8, d, d)
    _close(sv.grouped_sumvec_from_matrix(torch.from_numpy(c), b), rsv.grouped_sumvec_from_matrix(jnp.asarray(c), b))


@pytest.mark.parametrize("gamma,eps", [(1.0, 1e-4), (0.5, 1e-2)])
def test_variance_hinge_matches_the_reference(gamma, eps):
    # features of spread 0.2 to 2: some under the hinge, some over it
    z = _arr(9, 12, 16) * np.linspace(0.2, 2.0, 16, dtype=np.float32)
    k = (z.T @ z / 11).astype(np.float32)
    _close(regs.r_var(torch.from_numpy(k), gamma, eps), rregs.r_var(jnp.asarray(k), gamma, eps))
    _close(regs.r_var_from_embeddings(torch.from_numpy(z), gamma, eps),
           rregs.r_var_from_embeddings(jnp.asarray(z), gamma, eps))


@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("d,b", [(16, 4), (13, 4)], ids=["even", "ragged"])
def test_matrix_oracles_match_the_reference(q, d, b):
    c = _arr(10, d, d)
    _close(regs.r_sum_from_matrix(torch.from_numpy(c), q), rregs.r_sum_from_matrix(jnp.asarray(c), q))
    _close(regs.r_sum_grouped_from_matrix(torch.from_numpy(c), b, q),
           rregs.r_sum_grouped_from_matrix(jnp.asarray(c), b, q))


@pytest.mark.parametrize("d", [1, 7, 12, 64, 2039, 2048, 4096, 8192, 6000])
def test_choose_factors_equals_the_reference(d):
    got = fops.choose_factors(d)
    assert got == tuple(rfops.choose_factors(d))
    assert got[0] * got[1] == d and got[0] <= got[1]


@pytest.mark.parametrize("shape", [(3, 16), (2, 13)])
def test_spectrum_ref_matches_the_reference(shape):
    x = _arr(11, *shape)
    got = fref.spectrum_ref(torch.from_numpy(x))
    assert got.dtype == torch.complex64
    _close(got, rfref.spectrum_ref(jnp.asarray(x)))


# ---------------------------------------------------------------------------
# the identities the reference's tests pin, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [8, 13])
def test_convolving_the_involution_is_correlation(d):
    x, y = torch.from_numpy(_arr(12, 5, d)), torch.from_numpy(_arr(13, 5, d))
    got = sv.circular_convolve(sv.involution(x), y)
    np.testing.assert_allclose(got.numpy(), sv.circular_correlate_naive(x, y).numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", [16, 13])
def test_sumvec_direct_equals_sumvec_fft(d):
    z1, z2 = (torch.from_numpy(z) for z in _views(14, 32, d))
    np.testing.assert_allclose(sv.sumvec_direct(z1, z2, scale=32.0).numpy(),
                               sv.sumvec_fft(z1, z2, scale=32.0).numpy(), rtol=0, atol=1e-3)
    c = regs.cross_correlation_matrix(z1, z2, scale=32.0)
    np.testing.assert_allclose(sv.grouped_sumvec_fft(z1, z2, 4, scale=32.0).numpy(),
                               sv.grouped_sumvec_from_matrix(c, 4).numpy(), rtol=0, atol=1e-3)


def _standardized(seed, n, d):
    z1, z2 = _views(seed, n, d)
    return standardize(torch.from_numpy(z1)), standardize(torch.from_numpy(z2))


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("d", [32, 31])
def test_r_sum_equals_its_matrix_definition(impl, q, d):
    z1, z2 = _standardized(15, 64, d)
    c = regs.cross_correlation_matrix(z1, z2)
    got = float(regs.r_sum(z1, z2, q=q, scale=64.0, impl=impl))
    want = float(regs.r_sum_from_matrix(c, q))
    assert got == pytest.approx(want, rel=1e-3)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("d,b", [(32, 8), (30, 8)], ids=["even", "ragged"])
def test_r_sum_grouped_equals_its_matrix_definition(impl, q, d, b):
    z1, z2 = _standardized(16, 64, d)
    c = regs.cross_correlation_matrix(z1, z2)
    got = float(regs.r_sum_grouped(z1, z2, b, q=q, scale=64.0, impl=impl))
    want = float(regs.r_sum_grouped_from_matrix(c, b, q))
    assert got == pytest.approx(want, rel=1e-3, abs=1e-4)
