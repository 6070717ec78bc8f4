"""The kernels' autograd rules against the reference's ``custom_vjp``s.

Each port kernel is a ``torch.autograd.Function`` whose backward runs the
kernels again (on the CPU, their plain versions).  Here every forward and
every vjp is held against ``jax.vjp`` of the reference kernel (Pallas in
interpret mode) on the same seeded inputs and cotangents, at the
reference's kernel tolerance (rtol = atol = 2e-4).  A stand-in for the CUDA
launcher then drives the wrappers' CUDA branch on the CPU, forward and
backward, so every operand a kernel would get on the card is checked
against the kernels' layout rule and every launch is counted.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.grouped_sumvec import kernel as rg  # noqa: E402
from repro.kernels.sumvec_fft import kernel as rf  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.grouped_sumvec import kernel as tg  # noqa: E402
from repro_torch.kernels.sumvec_fft import kernel as tf  # noqa: E402
from repro_torch.kernels.xcorr_offdiag import kernel as tx  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _leaves(seed, shapes, grad_mask):
    """numpy arrays and the matching torch leaves (requires_grad per mask)."""
    xs = _arrays(seed, *shapes)
    ts = [torch.from_numpy(x).requires_grad_(g) for x, g in zip(xs, grad_mask)]
    return xs, ts


def _check_vjp(ref_fn, port_fn, xs, ts, cot, grad_mask):
    """Forward outputs and the vjp of every input that requires a grad."""
    want_out, vjp = jax.vjp(ref_fn, *(jnp.asarray(x) for x in xs))
    want_grads = vjp(tuple(jnp.asarray(c) for c in cot) if isinstance(want_out, (tuple, list)) else jnp.asarray(cot[0]))
    got_out = port_fn(*ts)
    got_out = got_out if isinstance(got_out, tuple) else (got_out,)
    want_out = want_out if isinstance(want_out, (tuple, list)) else (want_out,)
    for g, w in zip(got_out, want_out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    inputs = [t for t, m in zip(ts, grad_mask) if m]
    got_grads = torch.autograd.grad(got_out, inputs, [torch.from_numpy(c) for c in cot])
    for g, w in zip(got_grads, [w for w, m in zip(want_grads, grad_mask) if m]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize(
    "m,k,n,grad_b", [(13, 7, 5, False), (40, 33, 130, False), (21, 9, 11, True)], ids=["small", "wide", "grad-b"]
)
def test_cmatmul_vjp_matches_reference(m, k, n, grad_b):
    mask = (True, True, grad_b, grad_b)
    xs, ts = _leaves(m + k, [(m, k), (m, k), (k, n), (k, n)], mask)
    cot = _arrays(n, (m, n), (m, n))
    _check_vjp(rf.cmatmul, tf.cmatmul, xs, ts, cot, mask)


@pytest.mark.parametrize("grad_b", [False, True], ids=["const-basis", "grad-b"])
def test_cmatmul_real_a_vjp_matches_reference(grad_b):
    """ai=None (the four-step's first stage): the port takes Re dA only; the
    reference feeds zeros as Ai and drops dAi."""
    m, k, n = 24, 8, 8
    mask = (True, grad_b, grad_b)
    (ar, br, bi), ts = _leaves(3, [(m, k), (k, n), (k, n)], mask)
    cot = _arrays(4, (m, n), (m, n))
    ref = lambda a, b_r, b_i: rf.cmatmul(a, jnp.zeros_like(a), b_r, b_i)
    port = lambda a, b_r, b_i: tf.cmatmul(a, None, b_r, b_i)
    _check_vjp(ref, port, [ar, br, bi], ts, cot, mask)


@pytest.mark.parametrize("n,d,grad_w", [(5, 37, False), (17, 130, True)], ids=["const-w", "grad-w"])
def test_ctwiddle_vjp_matches_reference(n, d, grad_w):
    mask = (True, True, grad_w, grad_w)
    xs, ts = _leaves(n * d, [(n, d), (n, d), (d,), (d,)], mask)
    cot = _arrays(d, (n, d), (n, d))
    _check_vjp(rf.ctwiddle, tf.ctwiddle, xs, ts, cot, mask)


@pytest.mark.parametrize("m,k,n", [(13, 7, 5), (70, 130, 9)])
def test_pmatmul_vjp_matches_reference(m, k, n):
    mask = (True, True)
    xs, ts = _leaves(m * n, [(m, k), (k, n)], mask)
    _check_vjp(rg.pmatmul, tg.pmatmul, xs, ts, _arrays(k, (m, n)), mask)


@pytest.mark.parametrize("f,k,n,nb", [(3, 11, 5, 7), (2, 20, 16, 16)])
def test_freq_outer_vjp_matches_reference(f, k, n, nb):
    mask = (True, True)
    xs, ts = _leaves(f * k, [(f, k, n), (f, k, nb)], mask)
    _check_vjp(rg.freq_outer, tg.freq_outer, xs, ts, _arrays(n, (f, n, nb)), mask)


@pytest.mark.parametrize("f,k,n,n2", [(3, 11, 5, 7), (2, 20, 16, 16), (2, 9, 70, 3)])
def test_freq_mat_vjp_matches_reference(f, k, n, n2):
    mask = (True, True)
    xs, ts = _leaves(f * k + n, [(f, k, n), (f, n, n2)], mask)
    _check_vjp(rg.freq_mat, tg.freq_mat, xs, ts, _arrays(n2, (f, k, n2)), mask)


def test_freq_mat_plain_matches_reference_raw():
    a, m = _arrays(9, (4, 12, 6), (4, 6, 10))
    want = rg._freq_mat_raw(jnp.asarray(a), jnp.asarray(m))
    np.testing.assert_allclose(tg.freq_mat(torch.from_numpy(a), torch.from_numpy(m)).numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the wrappers' CUDA branch, driven on the CPU through a launcher stand-in
# ---------------------------------------------------------------------------


def _fake_launch(family, name, device, *args):
    """Computes what ``<family>_<name>`` would, into its output buffers, after
    holding every tensor argument to the kernels' rule (contiguous f32)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            assert a.is_contiguous() and a.dtype == torch.float32, (family, name)
    key = (family, name)
    if key == ("sumvec_fft", "cmatmul"):
        ar, ai, br, bi, cr, ci, m, k, n = args
        assert ar.shape == (m, k) and br.shape == (k, n) and cr.shape == (m, n)
        want_r, want_i = tf.cmatmul_plain(ar, ai, br, bi)
        cr.copy_(want_r)
        if ci is not None:
            ci.copy_(want_i)
    elif key == ("sumvec_fft", "ctwiddle"):
        xr, xi, wr, wi, yr, yi, n, d = args
        assert xr.shape == (n, d) and wr.shape == (d,)
        for out, want in zip((yr, yi), tf.ctwiddle_plain(xr, xi, wr, wi)):
            out.copy_(want)
    elif key == ("grouped_sumvec", "pmatmul"):
        a, b, out, m, k, n = args
        assert a.shape == (m, k) and b.shape == (k, n)
        out.copy_(tg.pmatmul_plain(a, b))
    elif key == ("grouped_sumvec", "freq_outer"):
        a, b, out, f, k, n, nb = args
        assert a.shape == (f, k, n) and b.shape == (f, k, nb)
        out.copy_(tg.freq_outer_plain(a, b))
    elif key == ("grouped_sumvec", "freq_mat"):
        a, m, out, f, k, n, n2 = args
        assert a.shape == (f, k, n) and m.shape == (f, n, n2)
        out.copy_(tg.freq_mat_plain(a, m))
    elif key == ("xcorr_offdiag", "off_diagonal_sq_sum"):
        z1, z2, partial, out, n, d = args
        assert z1.shape == z2.shape == (n, d) and partial.numel() == (-(-d // tx.TILE)) ** 2
        assert partial.shape == ((-(-d // 128)) ** 2,) and out.shape == () and n > 0 and d > 0
        out.copy_(tx.off_diagonal_sq_sum_plain(z1, z2))
    else:
        raise AssertionError(f"unknown kernel {key}")
    return True  # launched: the wrapper counts it


@pytest.fixture
def cuda_branch(monkeypatch):
    """Route every wrapper into its CUDA branch with the stand-in launcher."""
    from repro_torch.kernels import utils

    def check_operand(name, x, shape):
        # the CUDA rule minus the device test
        assert x.dtype == torch.float32 and tuple(x.shape) == tuple(shape) and x.is_contiguous(), name

    for mod in (tf, tg, tx):
        monkeypatch.setattr(mod, "route", lambda *xs: "cuda")
        monkeypatch.setattr(mod, "check_operand", check_operand)
    monkeypatch.setattr(build, "launch", _fake_launch)
    assert utils.route(torch.ones(1)) == "cpu"  # the real rule is untouched
    kernels.reset_launch_counts()
    yield
    kernels.reset_launch_counts()


@pytest.mark.parametrize(
    "d,b,q,style",
    [(96, None, 2, "bt"), (96, None, 1, "vic"), (61, None, 1, "bt"), (61, None, 2, "vic"),
     (96, 16, 2, "bt"), (96, 16, 1, "vic"), (40, 8, 1, "bt")],
)
def test_kernel_route_forward_and_backward_take_kernel_layouts(cuda_branch, d, b, q, style):
    """Loss and gradients of the kernel route equal the plain route's, every
    operand the kernels get (forward and vjp) obeys their layout rule, and
    the backward pass is counted under every kernel of the route."""
    from repro_torch.decorr import DecorrConfig, apply

    rng = np.random.default_rng(d + q)
    z1, z2 = (torch.from_numpy(rng.standard_normal((8, d)).astype(np.float32)).requires_grad_() for _ in range(2))
    cfg = DecorrConfig(style=style, q=q, block_size=b)
    perm = torch.from_numpy(rng.permutation(d))
    got_loss, _ = apply(z1, z2, cfg, perm, impl="kernel")
    got = torch.autograd.grad(got_loss, (z1, z2))
    fwd, bwd = kernels.launch_counts(), kernels.backward_launch_counts()
    want_loss, _ = apply(z1, z2, cfg, perm, impl="plain")
    want = torch.autograd.grad(want_loss, (z1, z2))
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss.detach()), rtol=5e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=5e-4, atol=5e-4 * float(w.abs().max()))
    names = ("cmatmul", "ctwiddle") if b is None else ("pmatmul", "freq_outer", "freq_mat")
    assert all(fwd[k] > 0 and bwd[k] > 0 for k in names), (fwd, bwd)
    assert fwd["xcorr_offdiag"] == 0


def test_freq_outer_backward_counts_freq_mat_under_both(cuda_branch):
    a = torch.randn(3, 10, 4, requires_grad=True)
    b = torch.randn(3, 10, 5, requires_grad=True)
    torch.autograd.grad(tg.freq_outer(a, b).sum(), (a, b))
    assert kernels.launch_counts() == {
        "cmatmul": 0, "ctwiddle": 0, "pmatmul": 0, "freq_outer": 1, "freq_mat": 2, "xcorr_offdiag": 0,
        "paged_attention": 0,
    }
    assert kernels.backward_launch_counts() == {
        "cmatmul": 0, "ctwiddle": 0, "pmatmul": 0, "freq_outer": 2, "freq_mat": 2, "xcorr_offdiag": 0,
        "paged_attention": 0,
    }


def test_constant_bases_get_no_gradient_work(cuda_branch, monkeypatch):
    """The vjp of a product with a constant basis launches dA only (one
    kernel), and the real-input stage asks for Re dA only (a null Ci)."""
    seen = []

    def spy(family, name, device, *args):
        seen.append((name, args[5] is None))  # cmatmul's Ci output buffer
        return _fake_launch(family, name, device, *args)

    monkeypatch.setattr(build, "launch", spy)
    x = torch.randn(12, 8, requires_grad=True)
    br, bi = torch.randn(8, 8), torch.randn(8, 8)
    cr, ci = tf.cmatmul(x, None, br, bi)
    torch.autograd.grad((cr * cr + ci).sum(), x)
    assert seen == [("cmatmul", False), ("cmatmul", True)]


@pytest.mark.parametrize("n,d", [(8, 37), (17, 128), (5, 129), (3, 300)])
def test_xcorr_offdiag_cuda_branch_takes_kernel_layouts(cuda_branch, n, d):
    """The R_off wrapper's CUDA branch: one partial per 128 x 128 tile of C
    (``TILE``), a 0-d output, one launch; the loss route's gradient is the
    Gram trick in torch products, so the backward pass launches nothing."""
    from repro_torch.kernels.xcorr_offdiag import off_diagonal_sq_sum, off_diagonal_sq_sum_ref

    assert tx.TILE == 128
    rng = np.random.default_rng(n * d)
    z1, z2 = (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).requires_grad_() for _ in range(2))
    got = off_diagonal_sq_sum(z1, z2, scale=n)
    grads = torch.autograd.grad(got, (z1, z2))
    want = off_diagonal_sq_sum_ref(z1, z2, scale=n)
    np.testing.assert_allclose(float(got.detach()), float(want.detach()), rtol=2e-4)
    for g, w in zip(grads, torch.autograd.grad(want, (z1, z2))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=5e-4, atol=5e-4 * float(w.abs().max()))
    assert kernels.launch_counts()["xcorr_offdiag"] == 1
    assert kernels.backward_launch_counts()["xcorr_offdiag"] == 0
