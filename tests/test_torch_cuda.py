"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the test, never at import) where
no CUDA device is present.  On a GPU machine with the CUDA toolkit run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
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


# (m, k, n, real A, offset of Ar, Re output only): the plan widths N = 32
# (stage 1, real A), 48 (the LM probe's d = 2304), 64, 128 (d = 8192's
# stage 3 at a reduced M), 11 (the dp = 121 plan), 60 / 68 (d = 2039's
# padded plan); M = 1 and M no multiple of a strip's rows; Ar 4 bytes off a
# 16-byte boundary (no bulk copy); the vjp's Re-output case; N past one
# 128-column tile; K too deep for B to stay resident (a ring of K slices)
@pytest.mark.parametrize(
    "m,k,n,real_a,offset,real_out",
    [(13, 7, 5, False, 0, False), (200, 33, 130, False, 0, False), (1000, 32, 32, True, 0, False),
     (4100, 32, 32, True, 0, False), (384, 48, 48, False, 0, False), (2000, 128, 128, False, 0, False),
     (300, 11, 11, False, 0, False), (1000, 60, 60, True, 0, False), (1000, 68, 68, False, 0, False),
     (1, 64, 64, False, 0, False), (8191, 64, 64, False, 0, False), (500, 64, 64, False, 1, False),
     (4100, 32, 32, False, 0, True), (8192, 64, 64, False, 0, True), (64, 600, 40, False, 0, False)],
)
def test_cmatmul_kernel_matches_plain(dev, m, k, n, real_a, offset, real_out):
    from repro_torch.kernels.sumvec_fft import kernel as K

    ar, br, bi = _view(dev, offset, m, k), _rand(dev, k, n), _rand(dev, k, n)
    ai = None if real_a else _rand(dev, m, k) * 0.5
    if real_out:  # the vjp of the real-input stage asks for Re(A @ B) only
        run = lambda: K._cmatmul_launch(ar, ai, br, bi, real_out=True)[:1]
        want = K.cmatmul_plain(ar, ai, br, bi)[:1]
    else:
        run = lambda: K.cmatmul(ar, ai, br, bi)
        want = K.cmatmul_plain(ar, ai, br, bi)
    before = K.cmatmul.launches
    got = run()
    torch.cuda.synchronize()
    assert K.cmatmul.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    # a fixed-order sum per output, no atomics: bit-identical on a rerun
    assert all(torch.equal(g, r) for g, r in zip(got, run()))


def _view(dev, offset, *shape):
    """A contiguous (``shape``) view ``offset`` floats into a buffer: offset 1
    starts 4 bytes past a 16-byte boundary, as a view at an offset may reach
    a kernel."""
    size = int(np.prod(shape))
    buf = torch.randn(offset + size, generator=torch.Generator().manual_seed(sum(shape) + offset))
    return buf.to(dev)[offset:].view(*shape)


# (n, d, offset of xr): d % 4 != 0 (the padded plan's dp = 121), n = 1 (the
# inverse twiddle of d = 2039), n not a multiple of the rows a thread owns,
# and xr at an odd offset all take the kernel's other paths
@pytest.mark.parametrize(
    "n,d,offset",
    [(5, 37, 0), (256, 2048, 0), (256, 121, 0), (256, 2048, 1), (1, 4080, 0), (7, 2048, 0),
     (257, 8192, 0), (3, 121, 1)],
)
def test_ctwiddle_kernel_matches_plain(dev, n, d, offset):
    from repro_torch.kernels.sumvec_fft import kernel as K

    args = (_view(dev, offset, n, d), _rand(dev, n, d) * 0.5, _rand(dev, d), _rand(dev, d) * 0.5)
    before = K.ctwiddle.launches
    got = K.ctwiddle(*args)
    want = K.ctwiddle_plain(*args)
    torch.cuda.synchronize()
    assert K.ctwiddle.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


# (m, k, n, offset of A): N in {65, 128, 130} and one past a block's 132
# columns; K = 130 and 65, whose rows are not 16-byte aligned (A stays
# resident), also at an odd offset, and K = 257 (too deep to stay: 4-byte
# pieces, a 1-deep last slice); the vjp's dB (K over many ring stages);
# M = 1, M = 16384 (d = 8192), A at an odd offset
@pytest.mark.parametrize(
    "m,k,n,offset",
    [(13, 7, 5, 0), (4096, 128, 130, 0), (300, 128, 65, 0), (4096, 130, 128, 0), (256, 65, 128, 0),
     (300, 130, 128, 1), (77, 257, 130, 0), (128, 4096, 130, 0), (1, 128, 130, 0), (16384, 128, 130, 0),
     (4096, 128, 130, 1), (70, 40, 300, 0)],
)
def test_pmatmul_kernel_matches_plain(dev, m, k, n, offset):
    from repro_torch.kernels.grouped_sumvec import kernel as K

    a, b = _view(dev, offset, m, k), _rand(dev, k, n) * 0.5
    before = K.pmatmul.launches
    got = K.pmatmul(a, b)
    torch.cuda.synchronize()
    assert K.pmatmul.launches == before + 1
    # the dB shape sums 4096 products (outputs reach ~100): atol is 2e-4 of
    # that scale there, as for freq_outer's 512-term sums
    atol = 2e-2 if k > 512 else 2e-4
    torch.testing.assert_close(got, K.pmatmul_plain(a, b), rtol=2e-4, atol=atol)
    # a fixed-order sum per output, no atomics: bit-identical on a rerun
    assert torch.equal(K.pmatmul(a, b), got)


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


# (f, k, n, n2, offset of a): N = N2 = 9 and a 4 bytes off a 16-byte
# boundary (the scalar twin), K no multiple of a block's rows, N2 past one
# 64-column tile
@pytest.mark.parametrize(
    "f,k,n,n2,offset",
    [(3, 11, 5, 7, 0), (65, 512, 16, 16, 0), (65, 512, 64, 64, 0), (2, 70, 130, 9, 0), (65, 512, 9, 9, 0),
     (65, 512, 16, 16, 1), (65, 500, 16, 16, 0), (65, 77, 64, 64, 0), (2, 70, 20, 130, 0)],
)
def test_freq_mat_kernel_matches_plain(dev, f, k, n, n2, offset):
    from repro_torch.kernels.grouped_sumvec import kernel as K

    a, m = _view(dev, offset, f, k, n), _rand(dev, f, n, n2) * 0.5
    before = K.freq_mat.launches
    got = K.freq_mat(a, m)
    torch.cuda.synchronize()
    assert K.freq_mat.launches == before + 1
    torch.testing.assert_close(got, K.freq_mat_plain(a, m), **TOL)
    # a fixed-order sum per output, no atomics: bit-identical on a rerun
    assert torch.equal(K.freq_mat(a, m), got)


# (n, d, offset of z1): one 128-wide tile (d = 128), a last tile column 1
# or 2 wide (d = 129, 130: the scalar twin), the ragged d = 2039, d = 8192;
# n = 1, 17 and 300 (no multiple of a ring stage's rows); z1 4 bytes off a
# 16-byte boundary (the scalar twin at d = 2048)
@pytest.mark.parametrize(
    "n,d,offset",
    [(5, 37, 0), (256, 2048, 0), (256, 2039, 0), (300, 130, 0), (256, 128, 0), (17, 129, 0), (1, 2039, 0),
     (17, 8192, 0), (256, 8192, 0), (300, 2048, 0), (1, 128, 0), (256, 2048, 1), (17, 130, 1)],
)
def test_xcorr_offdiag_kernel_matches_plain(dev, n, d, offset):
    from repro_torch.kernels.xcorr_offdiag import kernel as K

    z1, z2 = _view(dev, offset, n, d), _rand(dev, n, d) + 0.1
    before = K.off_diagonal_sq_sum_raw.launches
    got = K.off_diagonal_sq_sum_raw(z1, z2)
    want = K.off_diagonal_sq_sum_plain(z1, z2)
    torch.cuda.synchronize()
    assert K.off_diagonal_sq_sum_raw.launches == before + 1
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


def _paged_case(dev, b, h, kv, hd, page, lens, dtype, seed=0, q_gain=1.0, nb=0):
    """Seeded q (times ``q_gain``), page pools in ``dtype``, a permuted block
    table with a ragged page count per slot (unused entries on the sentinel
    page 0; at least ``nb`` entries wide)."""
    gen = torch.Generator().manual_seed(seed)
    nb = max(-(-max(lens) // page), nb)
    need = [-(-n // page) for n in lens]
    p_total = sum(need) + 1
    ids = (torch.randperm(p_total - 1, generator=gen) + 1).tolist()
    table = torch.zeros((b, nb), dtype=torch.int32)
    for i, k in enumerate(need):
        table[i, :k] = torch.tensor(ids[:k], dtype=torch.int32)
        ids = ids[k:]
    q = torch.randn(b, h, hd, generator=gen) * q_gain
    kp = torch.randn(p_total, page, kv, hd, generator=gen).to(dtype)
    vp = torch.randn(p_total, page, kv, hd, generator=gen).to(dtype)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    return [t.to(dev) for t in (q, kp, vp, table, lens_t)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 0), (0.0, 7), (50.0, 9)])
@pytest.mark.parametrize(
    "b,h,kv,hd,page,lens",
    [(3, 4, 2, 16, 8, [5, 17, 32]), (8, 8, 4, 256, 16, [1, 5, 17, 24, 33, 44, 16, 40]), (2, 3, 1, 48, 5, [1, 23]),
     (3, 8, 2, 128, 16, [70, 1, 33])],
    ids=["reference-shape", "gemma2-shape", "odd-page-hd48-mqa", "hd128-nrep4"],
)
def test_paged_attention_kernel_matches_plain(dev, dtype, softcap, window, b, h, kv, hd, page, lens):
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention.ops import paged_decode_plain

    q, kp, vp, table, lens_t = _paged_case(dev, b, h, kv, hd, page, lens, dtype)
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
    before = K.paged_decode_attention.launches
    got = K.paged_decode_attention(q, kp, vp, table, lens_t, **kw)
    want = paged_decode_plain(q, kp, vp, table, lens_t, **kw)
    torch.cuda.synchronize()
    assert K.paged_decode_attention.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, h, hd)
    torch.testing.assert_close(got, want, rtol=0.0, atol=2e-4 * max(1.0, float(want.abs().max())))
    # fixed-order merges, no atomics: bit-identical on a rerun
    assert torch.equal(K.paged_decode_attention(q, kp, vp, table, lens_t, **kw), got)


# the split kernel's edges (CHUNK = 256 rows a block): lengths at CHUNK - 1,
# CHUNK, CHUNK + 1 and past two chunks; a length of 1 in a 4096-row table
# (S = 16, 15 chunks empty); a window whose start falls inside a page, with
# a ragged last chunk; a window longer than every length; n_rep 1, 2, 4, 8
# with hd 48, 128, 256 and pages of 5 and 16
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "h,kv,hd,page,lens,softcap,window,nb",
    [(8, 4, 256, 16, [255, 256, 257, 1, 513, 767], 50.0, 0, 0),
     (8, 4, 256, 16, [1, 1, 2], 0.0, 0, 256),
     (8, 4, 256, 16, [1000, 777, 300, 5000, 1], 50.0, 700, 0),
     (8, 4, 256, 16, [8192, 300, 1, 40], 30.0, 9000, 0),
     (4, 4, 128, 5, [300, 1, 257, 40], 0.0, 0, 0),
     (8, 2, 128, 16, [513, 17, 256], 50.0, 300, 0),
     (8, 1, 48, 5, [700, 3, 255], 50.0, 300, 0),
     (4, 2, 48, 16, [4097, 2], 0.0, 4096, 0)],
    ids=["lens-at-chunk", "len1-wide-table", "window-lo-mid-chunk", "window-past-len", "nrep1-hd128-page5",
         "nrep4-hd128", "nrep8-hd48-page5", "nrep2-hd48-window4096"],
)
def test_paged_attention_split_edges_match_plain(dev, dtype, h, kv, hd, page, lens, softcap, window, nb):
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention.ops import paged_decode_plain

    q, kp, vp, table, lens_t = _paged_case(dev, len(lens), h, kv, hd, page, lens, dtype, seed=2, nb=nb)
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
    assert K.split_count(table.shape[1], page, window) > 1
    before = K.paged_decode_attention.launches
    got = K.paged_decode_attention(q, kp, vp, table, lens_t, **kw)
    want = paged_decode_plain(q, kp, vp, table, lens_t, **kw)
    torch.cuda.synchronize()
    assert K.paged_decode_attention.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0.0, atol=2e-4 * max(1.0, float(want.abs().max())))
    assert torch.equal(K.paged_decode_attention(q, kp, vp, table, lens_t, **kw), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("softcap,window", [(30.0, 0), (50.0, 0), (50.0, 9)])
def test_paged_attention_softcap_at_large_scores(dev, dtype, softcap, window):
    """q * 40 at gemma2's shape lifts |scale * q.k| to ~30-150, where the cap
    moves the output by far more than the tolerance (checked on the plain
    version), so the kernel's tanh cap is what the comparison holds."""
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention.ops import paged_decode_plain

    lens = [1, 5, 17, 24, 33, 44, 16, 40]
    q, kp, vp, table, lens_t = _paged_case(dev, 8, 8, 4, 256, 16, lens, dtype, seed=1, q_gain=40.0)
    kw = dict(scale=1.0 / 16.0, window=window)
    got = K.paged_decode_attention(q, kp, vp, table, lens_t, softcap=softcap, **kw)
    want = paged_decode_plain(q, kp, vp, table, lens_t, softcap=softcap, **kw)
    uncapped = paged_decode_plain(q, kp, vp, table, lens_t, **kw)
    tol = 2e-4 * max(1.0, float(want.abs().max()))
    assert float((want - uncapped).abs().max()) > 100 * tol
    torch.testing.assert_close(got, want, rtol=0.0, atol=tol)


def test_paged_attention_wrapper_rejects_wrong_layouts(dev):
    from repro_torch.kernels.paged_attention import kernel as K

    q, kp, vp, table, lens_t = _paged_case(dev, 2, 4, 2, 16, 8, [3, 9], torch.float32)
    with pytest.raises(TypeError, match="int32"):
        K.paged_decode_attention(q, kp, vp, table.long(), lens_t, scale=0.25)
    with pytest.raises(ValueError, match="contiguous"):
        K.paged_decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1), kp, vp, table, lens_t, scale=0.25)
    n = (kp.shape[0] - 1) * kp[0].numel()
    shifted = kp.reshape(-1)[1 : 1 + n].reshape(kp.shape[0] - 1, *kp.shape[1:])  # contiguous, 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        K.paged_decode_attention(q, shifted, shifted, table.clamp(max=shifted.shape[0] - 1), lens_t, scale=0.25)


@pytest.mark.parametrize("page", [8, 16])
def test_paged_engine_kernel_route_matches_plain_route(dev, page):
    """Reduced gemma2 on the card: the paged engine's tokens on the kernel
    route equal the plain (gather) route's, and the kernel launched once per
    layer per decode tick."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ContinuousLMEngine
    from repro_torch.serve.service import LMService

    cfg = get_config("gemma2-2b").reduced()
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    spec = [(rng.integers(0, cfg.vocab_size, s).astype(np.int32), m) for s, m in
            [(4, 5), (9, 3), (13, 8), (24, 2), (1, 4), (7, 7)]]
    outs = {}
    for impl in (None, "plain"):
        eng = ContinuousLMEngine(cfg, params, n_slots=4, max_len=48, max_prompt_len=24,
                                 paged=True, page_size=page, impl=impl, device=dev)
        svc = LMService(eng).warmup()
        kernels.reset_launch_counts()
        futs = [svc.submit(t, m) for t, m in spec]
        svc.drain()
        outs[impl] = [f.result(timeout=30) for f in futs]
        launches = kernels.launch_counts()["paged_attention"]
        assert launches == (cfg.n_layers * eng.pool.steps if impl is None else 0)
    for a, b in zip(outs[None], outs["plain"]):
        np.testing.assert_array_equal(a, b)
