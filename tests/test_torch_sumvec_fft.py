"""The port's four-step sumvec ops (kernel route, plain kernel versions on
CPU) against the reference's Pallas pipeline in interpret mode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.sumvec_fft import ops as rops  # noqa: E402
from repro_torch.kernels.sumvec_fft import ops as tops  # noqa: E402
from repro_torch.kernels.sumvec_fft import ref as tref  # noqa: E402

RTOL = 5e-4  # the reference's loss tolerance


def _views(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


@pytest.mark.parametrize("d", [64, 96, 61])
@pytest.mark.parametrize("q", [1, 2])
def test_r_sum_fourstep_matches_reference(d, q):
    z1, z2 = _views(12, d, seed=d)
    want = float(rops.r_sum_fourstep(jnp.asarray(z1), jnp.asarray(z2), q=q, scale=12.0))
    got = float(tops.r_sum_fourstep(torch.from_numpy(z1), torch.from_numpy(z2), q=q, scale=12.0))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("d", [64, 61])
def test_sumvec_fourstep_matches_reference(d):
    z1, z2 = _views(9, d, seed=d + 1)
    want = np.asarray(rops.sumvec_fourstep(jnp.asarray(z1), jnp.asarray(z2), scale=9.0))
    got = tops.sumvec_fourstep(torch.from_numpy(z1), torch.from_numpy(z2), scale=9.0).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("d", [48, 61])
def test_sumvec_fourstep_matches_direct_oracle(d):
    z1, z2 = (torch.from_numpy(z) for z in _views(7, d, seed=3))
    got = tops.sumvec_fourstep(z1, z2, scale=7.0)
    want = tref.sumvec_ref(z1, z2, scale=7.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_self_correlation_reuses_the_transform_and_agrees():
    z, _ = _views(10, 64, seed=5)
    a = torch.from_numpy(z)
    same = tops.r_sum_fourstep(a, a, q=2, scale=10.0)
    copied = tops.r_sum_fourstep(a, a.clone(), q=2, scale=10.0)
    np.testing.assert_allclose(float(same), float(copied), rtol=1e-6)


@pytest.mark.parametrize("d", [64, 61, 1000, 2039, 2048, 8192])
def test_fft_plan_equals_reference_pick(d):
    want = rops.fft_plan(d)
    got = tops.fft_plan(d)
    assert (got.d, got.dp, got.d1, got.d2) == (want.d, want.dp, want.d1, want.d2)


@pytest.mark.parametrize(
    "kw",
    [dict(d=61, dp=100, d1=10, d2=10), dict(d=64, dp=64, d1=8, d2=9)],
    ids=["padded-below-2d-1", "factors-mismatch"],
)
def test_bad_plans_raise_like_reference(kw):
    with pytest.raises(ValueError):
        rops.FFTPlan(**kw)
    with pytest.raises(ValueError):
        tops.FFTPlan(**kw)


def test_stale_plan_raises():
    z = torch.zeros(4, 64)
    with pytest.raises(ValueError):
        tops.r_sum_fourstep(z, z, plan=tops.fft_plan(61))
    with pytest.raises(ValueError):
        tops.sumvec_fourstep(z, z, plan=tops.fft_plan(61))
