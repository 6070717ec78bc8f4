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


# (m, k, n, real A, offset of Ar, Re output only) — the LM train step's aux
# loss at n = 64, d = 2304 (stages of 48) and n = 32, d = 5120 (64 and 80)
# at the end — and: the plan widths N = 32
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
     (4100, 32, 32, False, 0, True), (8192, 64, 64, False, 0, True), (64, 600, 40, False, 0, False),
     (3072, 48, 48, True, 0, False), (3072, 48, 48, False, 0, False), (3072, 48, 48, False, 0, True),
     (2560, 64, 64, True, 0, False), (2048, 80, 80, False, 0, False)],
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
     (257, 8192, 0), (3, 121, 1), (64, 2304, 0), (32, 5120, 0)],
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
     (4096, 128, 130, 1), (70, 40, 300, 0), (1152, 128, 130, 0), (1152, 130, 128, 0)],
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


# (f, k, n, nb, offset of a).  The register-fed kernel: N = 1 (d = b = 128
# grouped) and N = 9 (4-byte loads), N != NB with N past one 64-wide tile,
# N = 16 against NB = 64, K = 1, K = 500, K = 4096, a 4 bytes off a 16-byte
# boundary (4-byte loads), tiles halved below 64 x 64 to fit a block's
# threads (N = 50 against NB = 130, N = NB = 48 at F = 132), K = 0 at N =
# NB = 64 (zeros).  The staged kernel (N, NB >= 64): N = 64 (d =
# 8192, also freq_mat's vjp dm = freq_outer(a, g) there), K = 1, K = 1000 (a
# ring refilled), N = 130 and NB = 100 (4-byte pieces for a, a tensor copy
# for b, ragged tiles), a 4 bytes off
@pytest.mark.parametrize(
    "f,k,n,nb,offset",
    [(3, 11, 5, 7, 0), (65, 512, 16, 16, 0), (65, 512, 1, 1, 0), (65, 512, 9, 9, 0), (65, 512, 64, 64, 0),
     (2, 70, 130, 9, 0), (65, 512, 16, 64, 0), (65, 1, 16, 16, 0), (65, 500, 16, 16, 0), (65, 4096, 16, 16, 0),
     (65, 512, 16, 16, 1), (65, 1, 64, 64, 0), (65, 1000, 64, 64, 0), (4, 300, 130, 100, 0), (65, 512, 64, 64, 1),
     (65, 64, 50, 130, 0), (132, 64, 48, 48, 0), (65, 0, 64, 64, 0), (65, 128, 18, 18, 0)],
)
def test_freq_outer_kernel_matches_plain(dev, f, k, n, nb, offset):
    from repro_torch.kernels.grouped_sumvec import kernel as K

    a, b = _view(dev, offset, f, k, n), _rand(dev, f, k, nb) * 0.5
    before = K.freq_outer.launches
    got = K.freq_outer(a, b)
    torch.cuda.synchronize()
    assert K.freq_outer.launches == before + 1
    # sums of 512 products of unit normals reach ~10: atol is 2e-4 of that
    # scale; sums of 4096 reach ~100, as for pmatmul's dB
    atol = 2e-2 if k > 512 else 2e-3
    torch.testing.assert_close(got, K.freq_outer_plain(a, b), rtol=2e-4, atol=atol)
    # a fixed-order sum per output (over K groups), no atomics:
    # bit-identical on a rerun
    assert torch.equal(K.freq_outer(a, b), got)


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
     (65, 512, 16, 16, 1), (65, 500, 16, 16, 0), (65, 77, 64, 64, 0), (2, 70, 20, 130, 0), (65, 128, 18, 18, 0)],
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
     (17, 8192, 0), (256, 8192, 0), (300, 2048, 0), (1, 128, 0), (256, 2048, 1), (17, 130, 1), (64, 2304, 0)],
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


# a dense (B, L, KV, hd) cache split into blocks of rows, one page a slot
# (the placed decode's view): blocks of 512 rows (two chunks each) and of
# 64, a window crossing blocks, slots whose blocks are all empty past their
# length, n_rep 1 and 2
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "h,kv,hd,rows,blocks,lens,softcap,window",
    [(8, 4, 256, 512, 4, [1, 300, 1025, 2048, 700, 1500], 50.0, 0),
     (8, 4, 256, 512, 4, [1, 300, 1025, 2048, 700, 1500], 50.0, 600),
     (4, 4, 128, 64, 8, [1, 64, 65, 200, 512, 3], 0.0, 100)],
    ids=["global-nrep2", "window-nrep2", "small-blocks-nrep1"],
)
def test_paged_attention_blocks_with_start_and_lse_match_plain(dev, dtype, h, kv, hd, rows, blocks, lens, softcap,
                                                               window):
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention.ops import paged_decode_plain
    from repro_torch.parallel.fsdp_tp import merge_partials

    b = len(lens)
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(b, h, hd, generator=gen).to(dev)
    k = torch.randn(b, rows * blocks, kv, hd, generator=gen).to(dtype).to(dev)
    v = torch.randn(b, rows * blocks, kv, hd, generator=gen).to(dtype).to(dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    table = torch.arange(b, dtype=torch.int32, device=dev)[:, None]
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
    outs, lses = [], []
    for i in range(blocks):
        kb = k[:, i * rows:(i + 1) * rows].contiguous()
        vb = v[:, i * rows:(i + 1) * rows].contiguous()
        before = K.paged_decode_attention.launches
        out, lse = K.paged_decode_attention(q, kb, vb, table, lens_t, start=i * rows, return_lse=True, **kw)
        want, want_lse = paged_decode_plain(q, kb, vb, table, lens_t, start=i * rows, return_lse=True, **kw)
        torch.cuda.synchronize()
        assert K.paged_decode_attention.launches == before + 1
        tol = 2e-4 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(out, want, rtol=0.0, atol=tol)
        empty = torch.isinf(want_lse)
        assert torch.equal(torch.isinf(lse), empty) and bool((lse[empty] < 0).all())
        assert bool((out[empty] == 0).all())
        if bool((~empty).any()):  # a block past every slot's length has no live row at all
            torch.testing.assert_close(lse[~empty], want_lse[~empty], rtol=0.0,
                                       atol=2e-4 * max(1.0, float(want_lse[~empty].abs().max())))
        outs.append(out)
        lses.append(lse)
    whole = paged_decode_plain(q, k.contiguous(), v.contiguous(), table, lens_t, **kw)
    got = merge_partials(torch.stack(outs), torch.stack(lses))
    torch.testing.assert_close(got, whole, rtol=0.0, atol=2e-4 * max(1.0, float(whole.abs().max())))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_at_the_verify_shape_matches_plain(dev, dtype):
    """The speculative verify's shape: 8 slots x 5 lanes = 40, the lanes of a
    slot on one table row at lengths len .. len + 4 (gemma2-2b heads, page
    16, softcap 50, window 4096)."""
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention.ops import paged_decode_plain

    base = [1, 5, 17, 24, 33, 44, 16, 40]
    q, kp, vp, table, _ = _paged_case(dev, 8, 8, 4, 256, 16, [n + 4 for n in base], dtype, seed=3)
    q = torch.randn(40, 8, 256, generator=torch.Generator().manual_seed(4)).to(dev)
    table = table.repeat_interleave(5, dim=0).contiguous()
    lens = torch.tensor([n + j for n in base for j in range(5)], dtype=torch.int32, device=dev)
    kw = dict(scale=1.0 / 16.0, softcap=50.0, window=4096)
    before = K.paged_decode_attention.launches
    got = K.paged_decode_attention(q, kp, vp, table, lens, **kw)
    want = paged_decode_plain(q, kp, vp, table, lens, **kw)
    torch.cuda.synchronize()
    assert K.paged_decode_attention.launches == before + 1
    torch.testing.assert_close(got, want, **TOL)


def test_warm_prefix_tokens_equal_unshared_on_the_card(dev):
    """Reduced gemma2 on the kernel route: warm requests resuming over
    shared pages (one through a copy-on-write page) emit the unshared
    chunk-all engine's tokens bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ContinuousLMEngine
    from repro_torch.serve.service import LMService

    cfg = get_config("gemma2-2b").reduced()
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 21).astype(np.int32)
    spec = [(np.concatenate([prefix, rng.integers(0, cfg.vocab_size, t).astype(np.int32)]), m)
            for t, m in [(3, 4), (2, 6), (5, 3), (4, 5)]]
    outs = {}
    for shared in (False, True):
        eng = ContinuousLMEngine(cfg, params, n_slots=4, max_len=48, max_prompt_len=26, paged=True, page_size=8,
                                 prefill_chunk=4, chunk_all=True, prefix_cache=shared, device=dev)
        svc = LMService(eng).warmup()
        futs = [svc.submit(*spec[0])]
        svc.drain()
        futs += [svc.submit(t, m) for t, m in spec[1:]]
        svc.drain()
        outs[shared] = [f.result(timeout=60) for f in futs]
        if shared:
            m = svc.metrics()
            assert m["paged_prefix_hits_total"] == 3 and m["paged_prefix_cow_total"] >= 1
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)


def test_chunked_attention_at_full_width_matches_full_attention(dev):
    """One gemma2-2b attention layer (8 query / 4 kv heads of 256, softcap
    50) on a 10240-token prompt: the online softmax over 2048-row chunk
    pairs against the materialized (S, S) scores, local and global."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention

    cfg = get_config("gemma2-2b")
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, 10240, n, 256, generator=gen).to(dev) * g for n, g in ((8, 3.0), (4, 3.0), (4, 1.0)))
    for spec in cfg.pattern:
        got = attention._chunked_attention(q, k, v, cfg, spec, cfg.attn_chunk_size)
        want = attention._full_attention(q, k, v, cfg, spec)
        err = float((got - want).abs().max())
        assert err <= 1e-4 * max(1.0, float(want.abs().max())), (spec.attn_type, err)
        del got, want
        torch.cuda.empty_cache()


# every GQA ratio of the port's archs at its head dim: n_rep 12 at hd 192
# (nemotron-4-340b: two groups of 6 query rows a kv head, rows loaded
# element by element), 7 (arctic), 6 (qwen2-vl), 5 (llama4), 8 and 1 at 128,
# 1 at 64 (musicgen); page 16, lengths past one 256-row chunk
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "h,kv,hd",
    [(96, 8, 192), (24, 2, 192), (56, 8, 128), (12, 2, 128), (40, 8, 128), (64, 8, 128), (32, 32, 128),
     (32, 32, 64)],
    ids=["nemotron-nrep12-hd192", "nrep12-kv2-hd192", "arctic-nrep7", "qwen2vl-nrep6", "llama4-nrep5",
         "qwen110b-nrep8", "codeqwen-mha", "musicgen-mha-hd64"],
)
def test_paged_attention_at_every_arch_geometry_matches_plain(dev, dtype, h, kv, hd):
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention.ops import paged_decode_plain

    lens = [600, 1, 257, 40]
    q, kp, vp, table, lens_t = _paged_case(dev, len(lens), h, kv, hd, 16, lens, dtype, seed=3)
    for window in (0, 300):
        kw = dict(scale=hd ** -0.5, window=window)
        before = K.paged_decode_attention.launches
        got = K.paged_decode_attention(q, kp, vp, table, lens_t, **kw)
        want = paged_decode_plain(q, kp, vp, table, lens_t, **kw)
        torch.cuda.synchronize()
        assert K.paged_decode_attention.launches == before + 1
        torch.testing.assert_close(got, want, rtol=0.0, atol=2e-4 * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("arch", ["arctic-480b", "llama4-scout-17b-a16e", "jamba-v0.1-52b", "rwkv6-3b",
                                  "qwen2-vl-2b", "musicgen-large"])
def test_reduced_moe_and_ssm_forward_on_the_card_matches_the_cpu(dev, arch):
    """The MoE dispatch, the Mamba and RWKV recurrences (RWKV's chunked
    path too), M-RoPE and the audio heads on CUDA tensors against the same
    weights on the CPU: score forward, then prefill + one decode step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_caches, init_params

    cfg = get_config(arch).reduced()
    if arch == "rwkv6-3b":
        cfg = dataclasses.replace(cfg, rwkv_chunk=8)
    params = init_params(cfg, seed=0, device="cpu")

    def move(tree):
        return {k: move(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    on_card = move(params)
    shape = (2, 24, cfg.n_codebooks) if cfg.frontend == "audio_codes" else (2, 24)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, shape).astype(np.int32))
    want = forward(params, cfg, toks)
    got = forward(on_card, cfg, toks.to(dev))
    tol = 1e-4 * max(1.0, float(want.logits.abs().max()))
    torch.testing.assert_close(got.logits.cpu(), want.logits, rtol=0.0, atol=tol)
    torch.testing.assert_close(got.aux["moe_aux"].cpu(), want.aux["moe_aux"], rtol=0.0, atol=1e-5)
    caches, caches_d = init_caches(cfg, 2, 32, "cpu"), init_caches(cfg, 2, 32, dev)
    forward(params, cfg, toks[:, :23], caches=caches, cache_len=0)
    forward(on_card, cfg, toks[:, :23].to(dev), caches=caches_d, cache_len=0)
    want = forward(params, cfg, toks[:, 23:], caches=caches, cache_len=23)
    got = forward(on_card, cfg, toks[:, 23:].to(dev), caches=caches_d, cache_len=23)
    torch.testing.assert_close(got.logits.cpu(), want.logits, rtol=0.0, atol=tol)
    for name, leafs in caches.items():
        for key, leaf in leafs.items():
            torch.testing.assert_close(caches_d[name][key].cpu(), leaf, rtol=0.0,
                                       atol=1e-5 * max(1.0, float(leaf.abs().max())))


@pytest.mark.parametrize("impl", [None, "plain"])
def test_moe_paged_decode_lanes_sharing_a_row_are_order_free_on_the_card(dev, impl):
    """The five free lanes of a MoE arch's decode tick write the sentinel
    page's row 0 together: on the card the row holds the last lane's k / v
    whatever order the writes land in, and the free lanes read it back
    (kernel route and plain route alike), over repeated calls."""
    from repro_torch.models import attention

    from repro_torch.configs import get_config

    cfg = get_config("llama4-scout-17b-a16e").reduced()
    b, kv, hd, page = 8, cfg.n_kv_heads, cfg.hd, 4
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, 1, h, hd)).astype(np.float32)).to(dev)
               for h in (cfg.n_heads, kv, kv))
    tables = torch.zeros((b, 2), dtype=torch.int32, device=dev)
    tables[5:, 0] = torch.tensor([1, 2, 3], dtype=torch.int32, device=dev)
    lens = torch.tensor([0] * 5 + [2] * 3, dtype=torch.int32, device=dev)
    for _ in range(20):
        cache = {"k_pages": torch.zeros((4, page, kv, hd), device=dev),
                 "v_pages": torch.zeros((4, page, kv, hd), device=dev)}
        out, _ = attention._paged_decode(q, k, v, cache, lens, tables, cfg, cfg.pattern[0], impl=impl)
        torch.cuda.synchronize()
        assert torch.equal(cache["k_pages"][0, 0], k[4, 0]) and torch.equal(cache["v_pages"][0, 0], v[4, 0])
        # one row to attend: each free lane's output is that row's v, per query head
        want = v[4, 0].repeat_interleave(cfg.n_heads // kv, dim=0)
        for lane in range(5):
            torch.testing.assert_close(out[lane, 0].float(), want, rtol=0.0, atol=1e-6)


# the LM train step's aux arms (``chip_smoke.py``'s [lmtrain]): VICReg-style
# R_sum ungrouped, R_sum b = 128, the fused R_off
LM_AUX = {
    "sum": dict(style="vic", reg="sum", q=2),
    "sum-b128": dict(style="vic", reg="sum", q=2, block_size=128),
    "off": dict(style="vic", reg="off", use_kernel=True),
}
LM_AUX_KERNELS = {"sum": ("cmatmul", "ctwiddle"), "sum-b128": ("pmatmul", "freq_outer", "freq_mat"),
                  "off": ("xcorr_offdiag",)}


@pytest.mark.parametrize("arm", list(LM_AUX))
def test_lm_aux_loss_at_the_train_shape_matches_plain_route(dev, arm):
    """The aux loss of a gemma2-2b train step (hidden (8, 128, 2304): 64
    subsampled rows) on the kernel route against the plain route: the loss
    and its gradient wrt the hidden states within 5e-4 relative."""
    from repro_torch import kernels
    from repro_torch.core import LMDecorrConfig, lm_decorrelation_loss
    from repro_torch.decorr import DecorrConfig

    cfg = LMDecorrConfig(enabled=True, decorr=DecorrConfig(**LM_AUX[arm]), nu=0.04)
    hidden = _rand(dev, 8, 128, 2304).requires_grad_()
    perm = torch.randperm(2304, generator=torch.Generator().manual_seed(1)).to(dev)
    kernels.reset_launch_counts()
    aux, _ = lm_decorrelation_loss(hidden, cfg, perm)
    (got,) = torch.autograd.grad(aux, hidden)
    counts = kernels.launch_counts()
    want_aux, _ = lm_decorrelation_loss(hidden, cfg, perm, impl="plain")
    (want,) = torch.autograd.grad(want_aux, hidden)
    torch.cuda.synchronize()
    assert abs(float(aux.detach()) - float(want_aux.detach())) <= 5e-4 * abs(float(want_aux.detach()))
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4 * float(want.abs().max()))
    assert all(counts[name] > 0 for name in LM_AUX_KERNELS[arm]), counts


@pytest.mark.parametrize("arm", list(LM_AUX))
def test_aliased_operands_get_the_sum_of_both_vjps_on_the_card(dev, arm):
    """``R(z, z)`` (the LM aux passes ``zc, zc``) through each kernel's
    autograd Function: the gradient equals the sum of both operands' vjps
    of ``R(z1, z2)`` at z1 = z2 = z, on the kernel route."""
    from repro_torch.core import regularizers as regs
    from repro_torch.kernels.xcorr_offdiag import off_diagonal_sq_sum

    kw = LM_AUX[arm]

    def reg(a, b):
        if kw["reg"] == "off":
            return off_diagonal_sq_sum(a, b, scale=63.0)
        return regs.r_sum_auto(a, b, q=2, block_size=kw.get("block_size"), scale=63.0)

    base = _rand(dev, 64, 2304)
    z = base.clone().requires_grad_()
    (got,) = torch.autograd.grad(reg(z, z), z)
    z1, z2 = base.clone().requires_grad_(), base.clone().requires_grad_()
    g1, g2 = torch.autograd.grad(reg(z1, z2), (z1, z2))
    torch.cuda.synchronize()
    want = g1 + g2
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# distributed training and serving at world size 1, telemetry (NCCL)
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl_mesh(dev):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for_devices

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh_for_devices(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["global", "tp"])
def test_probe_on_a_one_rank_mesh_equals_local_on_the_card(dev, nccl_mesh, mode):
    from repro_torch.decorr import DecorrConfig, probe_metrics
    from repro_torch.kernels.grouped_sumvec import kernel as G
    from repro_torch.parallel import sharding as shd

    z = _rand(dev, 256, 512)
    perm = torch.randperm(512, generator=torch.Generator().manual_seed(0)).to(dev)
    kw = dict(style="vic", reg="sum", q=2, block_size=128)
    want = probe_metrics(z, None, DecorrConfig(**kw), perm)
    before = G.pmatmul.launches
    with shd.sharding_context(nccl_mesh):
        got = probe_metrics(z, None, DecorrConfig(**kw, distributed=mode, axis_name="data",
                                                  model_axis="model" if mode == "tp" else None), perm)
    assert G.pmatmul.launches > before
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=5e-4, atol=1e-6)


@pytest.mark.parametrize("model_axis", [None, "model"])
def test_meshed_serve_engine_equals_unmeshed_on_the_card(dev, nccl_mesh, model_axis):
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.ssl import SSLModelConfig, init_ssl_model

    cfg = SSLModelConfig(input_dim=64, backbone_widths=(128,), projector_widths=(128, 256))
    model = init_ssl_model(cfg, seed=0, device=dev)
    x = _rand(dev, 40, 64)
    want = ServeEngine(cfg, model, device=dev).encode(x)
    got = ServeEngine(cfg, model, mesh=nccl_mesh, model_axis=model_axis, device=dev).encode(x)
    assert torch.equal(got, want)


def test_data_parallel_step_on_a_one_rank_mesh_equals_the_step(dev, nccl_mesh):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.decorrelation import LMDecorrConfig
    from repro_torch.data.synthetic import LMDataConfig, lm_batch
    from repro_torch.decorr import DecorrConfig
    from repro_torch.models import ParamTree, init_params
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import create_train_state, make_train_step

    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(), decorr=LMDecorrConfig(
        enabled=True, decorr=DecorrConfig(style="vic", reg="sum", q=2, block_size=16), tokens_per_seq=4))
    data = LMDataConfig(vocab_size=cfg.vocab_size, batch=4, seq_len=16)
    runs = []
    for kw in ({}, dict(mesh=nccl_mesh), dict(mesh=nccl_mesh, grad_shardings="fsdp")):
        state = create_train_state(ParamTree(init_params(cfg, seed=0, device=dev)), adamw())
        if kw.get("grad_shardings"):
            kw = dict(kw, grad_shardings=[("data",) + (None,) * (p.dim() - 1) for p in state.model.parameters()])
        step = make_train_step(cfg, adamw(), warmup_cosine(1e-3, 0, 10), num_microbatches=2, **kw)
        for s in range(2):
            state, m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in lm_batch(data, s).items()})
        runs.append((float(m["loss"]), [p.detach().clone() for p in state.model.parameters()]))
    for loss, params in runs[1:]:
        assert loss == pytest.approx(runs[0][0], rel=1e-6)
        for a, b in zip(params, runs[0][1]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_prefetcher_copies_on_a_side_stream_and_the_step_waits(dev):
    from repro_torch.data import LMDataConfig, ShardedPrefetcher, lm_batch, lm_iterator

    cfg = LMDataConfig(vocab_size=1000, batch=64, seq_len=512)
    it = ShardedPrefetcher(lm_iterator(cfg), depth=3, device=dev)
    for s in range(4):
        b = next(it)
        assert b["tokens"].is_cuda
        assert torch.equal(b["tokens"].cpu(), torch.from_numpy(lm_batch(cfg, s)["tokens"]))
    it.close()


def test_exec_timer_waits_for_the_device_and_the_profiler_sees_cuda(dev, tmp_path):
    from repro_torch.obs import ExecTimer, Profiler

    a = _rand(dev, 4096, 4096)
    t = ExecTimer()
    t0 = t.start()
    for _ in range(4):
        a @ a
    t.block(dev)
    t.observe("mm", t.elapsed(t0))
    (row,) = t.snapshot()
    assert row["best_s"] > 4 * 2 * 4096**3 / 1e15  # 4 GEMMs cannot finish faster than ~0.5 PFLOP/s
    p = Profiler(str(tmp_path))
    assert p.start()
    a @ a
    torch.cuda.synchronize()
    path = p.stop()
    assert path is not None and '"cat": "kernel"' in open(path).read()
