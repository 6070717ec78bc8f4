"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the test, never at import) where
no CUDA device is present.  On a GPU machine with the CUDA toolkit run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on the card")
    from repro_torch import resolve_device

    return resolve_device("cuda")


def _rand(dev, *shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(sum(shape))).to(dev)


@pytest.mark.parametrize("m,k,n,real_a", [(13, 7, 5, False), (200, 33, 130, False), (1000, 32, 32, True)])
def test_cmatmul_kernel_matches_plain(dev, m, k, n, real_a):
    from repro_torch.kernels.sumvec_fft import kernel as K

    ar, br, bi = _rand(dev, m, k), _rand(dev, k, n), _rand(dev, k, n)
    ai = None if real_a else _rand(dev, m, k) * 0.5
    before = K.cmatmul.launches
    got = K.cmatmul(ar, ai, br, bi)
    want = K.cmatmul_plain(ar, ai, br, bi)
    torch.cuda.synchronize()
    assert K.cmatmul.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize("n,d", [(5, 37), (256, 2048)])
def test_ctwiddle_kernel_matches_plain(dev, n, d):
    from repro_torch.kernels.sumvec_fft import kernel as K

    args = (_rand(dev, n, d), _rand(dev, n, d) * 0.5, _rand(dev, d), _rand(dev, d) * 0.5)
    for g, w in zip(K.ctwiddle(*args), K.ctwiddle_plain(*args)):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize("m,k,n", [(13, 7, 5), (4096, 128, 130)])
def test_pmatmul_kernel_matches_plain(dev, m, k, n):
    from repro_torch.kernels.grouped_sumvec import kernel as K

    a, b = _rand(dev, m, k), _rand(dev, k, n) * 0.5
    torch.testing.assert_close(K.pmatmul(a, b), K.pmatmul_plain(a, b), **TOL)


@pytest.mark.parametrize("f,k,n,nb", [(3, 11, 5, 7), (65, 512, 16, 16)])
def test_freq_outer_kernel_matches_plain(dev, f, k, n, nb):
    from repro_torch.kernels.grouped_sumvec import kernel as K

    a, b = _rand(dev, f, k, n), _rand(dev, f, k, nb) * 0.5
    # sums of 512 products of unit normals reach ~10: atol is 2e-4 of that scale
    torch.testing.assert_close(K.freq_outer(a, b), K.freq_outer_plain(a, b), rtol=2e-4, atol=2e-3)


def test_wrapper_rejects_non_contiguous_cuda_operand(dev):
    from repro_torch.kernels.grouped_sumvec import kernel as K

    a = _rand(dev, 8, 6).T  # (6, 8), not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        K.pmatmul(a, _rand(dev, 8, 4))


@pytest.mark.parametrize("block", [None, 16])
@pytest.mark.parametrize("q", [1, 2])
def test_r_sum_kernel_route_matches_plain_route(dev, block, q):
    from repro_torch.core import regularizers as regs

    z1, z2 = _rand(dev, 64, 96), _rand(dev, 64, 96) + 0.1
    got = regs.r_sum_auto(z1, z2, q=q, block_size=block, scale=64)
    want = regs.r_sum_auto(z1, z2, q=q, block_size=block, scale=64, impl="plain")
    torch.testing.assert_close(got, want, rtol=5e-4, atol=0.0)
