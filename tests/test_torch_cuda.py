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


@pytest.mark.parametrize("f,k,n,n2", [(3, 11, 5, 7), (65, 512, 16, 16), (65, 512, 64, 64), (2, 70, 130, 9)])
def test_freq_mat_kernel_matches_plain(dev, f, k, n, n2):
    from repro_torch.kernels.grouped_sumvec import kernel as K

    a, m = _rand(dev, f, k, n), _rand(dev, f, n, n2) * 0.5
    before = K.freq_mat.launches
    got = K.freq_mat(a, m)
    torch.cuda.synchronize()
    assert K.freq_mat.launches == before + 1
    torch.testing.assert_close(got, K.freq_mat_plain(a, m), **TOL)


@pytest.mark.parametrize("n,d", [(5, 37), (256, 2048), (256, 2039), (300, 130)])
def test_xcorr_offdiag_kernel_matches_plain(dev, n, d):
    from repro_torch.kernels.xcorr_offdiag import kernel as K

    z1, z2 = _rand(dev, n, d), _rand(dev, n, d) + 0.1
    got = K.off_diagonal_sq_sum_raw(z1, z2)
    want = K.off_diagonal_sq_sum_plain(z1, z2)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=0.0)
    # two passes in a fixed order, no atomics: bit-identical on a rerun
    assert torch.equal(K.off_diagonal_sq_sum_raw(z1, z2), got)


@pytest.mark.parametrize("n,d,block", [(64, 96, None), (64, 96, 16), (64, 61, None), (256, 2048, 128)])
@pytest.mark.parametrize("q", [1, 2])
def test_kernel_route_grad_matches_plain_route(dev, n, d, block, q):
    """``torch.autograd.grad`` through the kernels' own vjps equals the
    plain route's gradient, and the backward pass launched kernels."""
    from repro_torch import kernels
    from repro_torch.core import regularizers as regs

    z1 = _rand(dev, n, d).requires_grad_()
    z2 = (_rand(dev, n, d) + 0.1).requires_grad_()
    kernels.reset_launch_counts()
    got = torch.autograd.grad(regs.r_sum_auto(z1, z2, q=q, block_size=block, scale=n), (z1, z2))
    want = torch.autograd.grad(regs.r_sum_auto(z1, z2, q=q, block_size=block, scale=n, impl="plain"), (z1, z2))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=5e-4, atol=5e-4 * scale)
    names = ("cmatmul", "ctwiddle") if block is None else ("pmatmul", "freq_outer", "freq_mat")
    bwd = kernels.backward_launch_counts()
    assert all(bwd[name] > 0 for name in names), bwd


@pytest.mark.parametrize("n,d", [(64, 96), (200, 40)], ids=["gram", "matrix"])
def test_xcorr_offdiag_grad_matches_matrix_route(dev, n, d):
    from repro_torch.kernels.xcorr_offdiag import off_diagonal_sq_sum, off_diagonal_sq_sum_ref

    z1 = _rand(dev, n, d).requires_grad_()
    z2 = (_rand(dev, n, d) + 0.1).requires_grad_()
    got = torch.autograd.grad(off_diagonal_sq_sum(z1, z2, scale=n), (z1, z2))
    want = torch.autograd.grad(off_diagonal_sq_sum_ref(z1, z2, scale=n), (z1, z2))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=5e-4, atol=5e-4 * float(w.abs().max()))


@pytest.mark.parametrize(
    "loss", [dict(style="bt", block_size=128, q=2), dict(style="vic", q=1), dict(style="bt", reg="off", use_kernel=True)],
    ids=["bt-b128", "vic-ungrouped", "bt-roff-kernel"],
)
def test_ssl_train_step_on_card_matches_plain_route(dev, loss):
    """One ``make_ssl_train_step`` step at a small width: the kernel route's
    loss and updated parameters equal the plain route's."""
    from repro_torch.decorr import DecorrConfig
    from repro_torch.optim import lars
    from repro_torch.train import SSLModelConfig, create_train_state, init_ssl_model, make_ssl_train_step

    model_cfg = SSLModelConfig(input_dim=64, backbone_widths=(128,), projector_widths=(256, 256))
    batch = {"view1": _rand(dev, 96, 64), "view2": _rand(dev, 96, 64) * 0.5}
    out = {}
    for impl in (None, "plain"):
        opt = lars()
        state = create_train_state(init_ssl_model(model_cfg, seed=0, device=dev), opt)
        step, _ = make_ssl_train_step(model_cfg, DecorrConfig(**loss), opt, lambda s: 0.1, impl=impl)
        state, metrics = step(state, batch)
        out[impl] = (metrics[f"{loss['style']}_loss"], [p.detach().clone() for p in state.model.parameters()])
    torch.testing.assert_close(out[None][0], out["plain"][0], rtol=5e-4, atol=0.0)
    for a, b in zip(out[None][1], out["plain"][1]):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=1e-5)
