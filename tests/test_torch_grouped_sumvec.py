"""The port's grouped sumvec ops (kernel route, plain kernel versions on
CPU) against the reference's Pallas pipeline in interpret mode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.grouped_sumvec import ops as rops  # noqa: E402
from repro_torch.kernels.grouped_sumvec import ops as tops  # noqa: E402
from repro_torch.kernels.grouped_sumvec import ref as tref  # noqa: E402

RTOL = 5e-4  # the reference's loss tolerance


def _views(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("q", [1, 2])
def test_r_sum_kernel_matches_reference(b, q):
    z1, z2 = _views(10, 40, seed=b + q)
    want = float(rops.r_sum_kernel(jnp.asarray(z1), jnp.asarray(z2), block_size=b, q=q, scale=10.0))
    got = float(tops.r_sum_kernel(torch.from_numpy(z1), torch.from_numpy(z2), block_size=b, q=q, scale=10.0))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_block_dft_matches_reference():
    z, _ = _views(6, 40, seed=1)
    want = rops.block_dft(jnp.asarray(z), 16)
    got = tops.block_dft(torch.from_numpy(z), 16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,q", [(8, 1), (8, 2), (24, 2)])
def test_r_sum_kernel_matches_matrix_oracle(b, q):
    z1, z2 = (torch.from_numpy(z) for z in _views(8, 48, seed=7))
    got = tops.r_sum_kernel(z1, z2, block_size=b, q=q, scale=8.0)
    want = tref.r_sum_grouped_ref(z1, z2, b, q=q, scale=8.0)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_block_covering_d_is_ungrouped():
    z1, z2 = (torch.from_numpy(z) for z in _views(8, 16, seed=2))
    got = tops.r_sum_kernel(z1, z2, block_size=None, q=2, scale=8.0)
    want = tref.r_sum_ref(z1, z2, q=2, scale=8.0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


@pytest.mark.parametrize("d", [16, 100, 128, 2048, 8192])
def test_auto_block_size_matches_reference(d):
    assert tops.auto_block_size(d) == rops.auto_block_size(d)
