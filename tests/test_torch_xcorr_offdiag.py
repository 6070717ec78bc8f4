"""``repro_torch.kernels.xcorr_offdiag`` against ``repro.kernels.xcorr_offdiag``.

The fused R_off kernel's plain version against the reference's Pallas
kernel (interpret mode) on ragged shapes at the kernel tolerance (2e-4);
the Gram-trick backward against ``jax.grad`` of the reference's
``custom_vjp`` on both branches (n <= d: Gram matrices; n > d: the matrix
route) at the loss tolerance (5e-4); ``r_off_gram`` and the oracle too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.xcorr_offdiag import kernel as rk  # noqa: E402
from repro.kernels.xcorr_offdiag import ops as rops  # noqa: E402
from repro.kernels.xcorr_offdiag import ref as rref  # noqa: E402
from repro_torch.kernels.xcorr_offdiag import kernel as tk  # noqa: E402
from repro_torch.kernels.xcorr_offdiag import ops as tops  # noqa: E402
from repro_torch.kernels.xcorr_offdiag import ref as tref  # noqa: E402

RTOL = 5e-4


def _views(n, d, seed=0):
    rng = np.random.default_rng(seed + n * d)
    return rng.standard_normal((n, d)).astype(np.float32), rng.standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("n,d", [(8, 37), (16, 130), (24, 256)])
def test_raw_kernel_plain_matches_reference_pallas(n, d):
    z1, z2 = _views(n, d)
    want = float(rk.off_diagonal_sq_sum_raw(jnp.asarray(z1), jnp.asarray(z2)))
    got = float(tk.off_diagonal_sq_sum_raw(torch.from_numpy(z1), torch.from_numpy(z2)))
    np.testing.assert_allclose(got, want, rtol=2e-4)


@pytest.mark.parametrize("n,d", [(10, 40), (50, 12)], ids=["gram-n<=d", "matrix-n>d"])
@pytest.mark.parametrize("same", [False, True], ids=["two-views", "z2-is-z1"])
def test_loss_and_grads_match_reference(n, d, same):
    """Both Gram branches; ``z2 is z1`` (VICReg's covariance) gets the sum of
    both operands' gradients."""
    z1, z2 = _views(n, d, seed=1)
    s = float(n - 1)
    if same:
        ref_fn = lambda a: rops.off_diagonal_sq_sum(a, a, scale=s)
        want, want_g = jax.value_and_grad(ref_fn)(jnp.asarray(z1))
        t1 = torch.from_numpy(z1).requires_grad_()
        got = tops.off_diagonal_sq_sum(t1, t1, scale=s)
        got_g = torch.autograd.grad(got, t1)
        want_g = (want_g,)
    else:
        ref_fn = lambda a, b: rops.off_diagonal_sq_sum(a, b, scale=s)
        want, want_g = jax.value_and_grad(ref_fn, argnums=(0, 1))(jnp.asarray(z1), jnp.asarray(z2))
        t1, t2 = (torch.from_numpy(z).requires_grad_() for z in (z1, z2))
        got = tops.off_diagonal_sq_sum(t1, t2, scale=s)
        got_g = torch.autograd.grad(got, (t1, t2))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    for g, w in zip(got_g, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=RTOL * np.abs(w).max())


@pytest.mark.parametrize("scale", [None, 9.0])
def test_r_off_gram_and_oracle_match_reference(scale):
    z1, z2 = _views(10, 40, seed=2)
    j1, j2, t1, t2 = jnp.asarray(z1), jnp.asarray(z2), torch.from_numpy(z1), torch.from_numpy(z2)
    np.testing.assert_allclose(float(tops.r_off_gram(t1, t2, scale=scale)),
                               float(rops.r_off_gram(j1, j2, scale=scale)), rtol=RTOL)
    s = 1.0 if scale is None else scale
    np.testing.assert_allclose(float(tref.off_diagonal_sq_sum_ref(t1, t2, s)),
                               float(rref.off_diagonal_sq_sum_ref(j1, j2, s)), rtol=RTOL)


def test_wrapper_rejects_mismatched_views():
    with pytest.raises(ValueError):
        tk.off_diagonal_sq_sum_raw(torch.ones(4, 5), torch.ones(4, 6))
