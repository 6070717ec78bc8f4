"""``repro_torch.core.regularizers`` against ``repro.core.regularizers``:
plain route and kernel route (plain kernel versions on CPU), at 5e-4
relative — the reference's loss tolerance."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import regularizers as rregs  # noqa: E402
from repro.core import sumvec as rsv  # noqa: E402
from repro_torch.core import regularizers as tregs  # noqa: E402
from repro_torch.core import sumvec as tsv  # noqa: E402

RTOL = 5e-4
N, D = 10, 40


def _views(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, D)).astype(np.float32),
            rng.standard_normal((N, D)).astype(np.float32))


@pytest.mark.parametrize("b", [None, 1, 8, 64], ids=["ungrouped", "b1", "b8", "b-over-d"])
@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("impl", [None, "kernel"])
def test_r_sum_auto_matches_reference(b, q, impl):
    z1, z2 = _views(seed=q)
    want = float(rregs.r_sum_auto(jnp.asarray(z1), jnp.asarray(z2), q=q, block_size=b, scale=N))
    got = float(tregs.r_sum_auto(torch.from_numpy(z1), torch.from_numpy(z2), q=q, block_size=b,
                                 scale=N, impl=impl))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_r_off_and_cross_correlation_match_reference():
    z1, z2 = _views(seed=4)
    c_ref = rregs.cross_correlation_matrix(jnp.asarray(z1), jnp.asarray(z2))
    c = tregs.cross_correlation_matrix(torch.from_numpy(z1), torch.from_numpy(z2))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tregs.r_off(c)), float(rregs.r_off(c_ref)), rtol=RTOL)


def test_sumvec_primitives_match_reference():
    z1, z2 = _views(seed=6)
    j1, j2 = jnp.asarray(z1), jnp.asarray(z2)
    t1, t2 = torch.from_numpy(z1), torch.from_numpy(z2)
    np.testing.assert_allclose(tsv.sumvec_fft(t1, t2, scale=N).numpy(),
                               np.asarray(rsv.sumvec_fft(j1, j2, scale=N)), rtol=2e-4, atol=2e-4)
    g = tsv.grouped_frequency_accumulator(t1, t2, 8)
    g_ref = np.asarray(rsv.grouped_frequency_accumulator(j1, j2, 8))
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=2e-4, atol=2e-4)
    c = z1.T @ z2
    np.testing.assert_allclose(tsv.sumvec_from_matrix(torch.from_numpy(c)).numpy(),
                               np.asarray(rsv.sumvec_from_matrix(jnp.asarray(c))), rtol=1e-5, atol=1e-4)
    sq, s0 = tsv.sq_sum_and_zeroth_from_freq(tsv.frequency_accumulator(t1, t2), D)
    sq_r, s0_r = rsv.sq_sum_and_zeroth_from_freq(rsv.frequency_accumulator(j1, j2), D)
    np.testing.assert_allclose([float(sq), float(s0)], [float(sq_r), float(s0_r)], rtol=RTOL)


@pytest.mark.parametrize("bad", [dict(q=3), dict(impl="pallas")])
def test_bad_q_or_impl_raise(bad):
    z = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        tregs.r_sum(z, z, **bad)


def test_impl_follows_the_tensor_device():
    # a CPU tensor takes the plain route: no kernel wrapper is reached
    from repro_torch import kernels

    z1, z2 = (torch.from_numpy(z) for z in _views(seed=8))
    kernels.reset_launch_counts()
    plain = tregs.r_sum_auto(z1, z2, block_size=8, scale=N)
    kern = tregs.r_sum_auto(z1, z2, block_size=8, scale=N, impl="kernel")
    np.testing.assert_allclose(float(kern), float(plain), rtol=RTOL)
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize(
    "d,b,q",
    [(96, None, 1), (96, None, 2), (61, None, 1), (61, None, 2), (96, 16, 1), (96, 16, 2), (40, 8, 1)],
)
def test_kernel_route_hands_every_kernel_a_layout_it_takes(monkeypatch, d, b, q):
    """The CUDA wrappers raise on a non-contiguous or non-f32 operand; on the
    CPU they run the plain versions, which take any layout.  Stand-ins that
    check the CUDA rule catch an op that would raise on the card."""
    from repro_torch.kernels.grouped_sumvec import kernel as gk
    from repro_torch.kernels.sumvec_fft import kernel as fk

    seen = []

    def strict(name, plain, n_operands):
        def check(*xs):
            # the operands, then the optional cached conjugate / transpose
            # of the constant operand (a plane, or a pair of planes)
            for x in xs:
                for t in x if isinstance(x, tuple) else (x,):
                    if t is not None:
                        assert t.is_contiguous() and t.dtype == torch.float32, name
            seen.append(name)
            return plain(*xs[:n_operands])

        return check

    for mod, name, n_operands in ((fk, "cmatmul", 4), (fk, "ctwiddle", 4), (gk, "pmatmul", 2), (gk, "freq_outer", 2)):
        monkeypatch.setattr(mod, name, strict(name, getattr(mod, f"{name}_plain"), n_operands))
    rng = np.random.default_rng(d + q)
    z1, z2 = (torch.from_numpy(rng.standard_normal((8, d)).astype(np.float32)) for _ in range(2))
    got = tregs.r_sum_auto(z1, z2, q=q, block_size=b, scale=8, impl="kernel")
    want = tregs.r_sum_auto(z1, z2, q=q, block_size=b, scale=8, impl="plain")
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    assert seen
