"""The paged-attention kernel's plain version against the reference kernel,
and the wrapper's CUDA branch driven on the CPU.

The port's ``paged_decode_plain`` (the CPU route and the on-card yardstick
of ``csrc/paged_attention.cu``) is held against the reference's
``paged_decode_jnp`` and its Pallas kernel ``paged_decode_attention`` (in
interpret mode on the CPU) at ``tests/test_paging.py``'s shapes and its four
(softcap, window) cases, atol 1e-5.  A stand-in for the CUDA launcher then
routes the wrapper into its CUDA branch on the CPU, checks every operand
the kernel would get against its layout rule (f32 q, page dtype, int32
tables and lengths, contiguity, the C argument list, the split count and
its scratch) and counts the launches, alone and inside the paged engine.
The split count is shown to come from the table's sizes and the window
alone, and the kernel's merge of per-chunk softmax states (empty chunks
included) to equal the plain masked softmax.

A dense cache split by sequence into blocks (a rank's rows of the placed
decode): ``paged_decode_plain`` on each block with its ``start`` and its
log-sum-exp, merged by ``parallel/fsdp_tp.merge_partials``, equals the
reference's Pallas kernel (interpret mode) over the whole cache as pages and
the reference model's ``_decode_attention`` (windowed and global layers,
blocks with no live row, n_rep 1 and 2); the wrapper's CUDA branch passes
``start`` and the LSE buffer to the C entry.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import ops as rops  # noqa: E402
from repro.kernels.paged_attention.kernel import paged_decode_kernel_call  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as K  # noqa: E402
from repro_torch.kernels.paged_attention.ops import paged_decode_plain  # noqa: E402
from repro_torch.parallel.fsdp_tp import merge_partials  # noqa: E402

CASES = [(0.0, 0), (30.0, 0), (0.0, 7), (50.0, 9)]


def _inputs(seed=0, b=3, h=4, kv=2, hd=16, page=8, nb=4, lens=(5, 17, 32)):
    """``tests/test_paging.py``'s kernel-test inputs: a permuted block table
    over b * nb + 1 pages (page 0 the sentinel)."""
    rng = np.random.default_rng(seed)
    p_total = b * nb + 1
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    kp = rng.standard_normal((p_total, page, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((p_total, page, kv, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, p_total))[: b * nb].reshape(b, nb).astype(np.int32)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("softcap,window", CASES)
def test_plain_matches_reference_jnp_and_pallas(softcap, window):
    xs = _inputs()
    kw = dict(scale=0.25, softcap=softcap, window=window)
    got = paged_decode_plain(*(torch.from_numpy(x) for x in xs), **kw).numpy()
    jx = [jnp.asarray(x) for x in xs]
    np.testing.assert_allclose(got, np.asarray(rops.paged_decode_jnp(*jx, **kw)), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(rops.paged_decode_attention(*jx, **kw)), atol=1e-5)


@pytest.mark.parametrize("softcap", [30.0, 50.0])
def test_plain_matches_reference_at_large_scores(softcap):
    """q * 40 lifts |scale * q.k| to ~40-150, where the cap changes the
    output (the control: far from the uncapped output); the plain version
    still matches the reference's jnp and Pallas kernels there."""
    q, *rest = _inputs(seed=2)
    xs = (q * 40.0, *rest)
    kw = dict(scale=0.25, softcap=softcap, window=0)
    got = paged_decode_plain(*(torch.from_numpy(x) for x in xs), **kw).numpy()
    uncapped = paged_decode_plain(*(torch.from_numpy(x) for x in xs), scale=0.25).numpy()
    assert np.abs(got - uncapped).max() > 0.1
    jx = [jnp.asarray(x) for x in xs]
    np.testing.assert_allclose(got, np.asarray(rops.paged_decode_jnp(*jx, **kw)), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(rops.paged_decode_attention(*jx, **kw)), atol=1e-5)


def test_wrapper_cpu_route_is_the_plain_version_and_counts_nothing():
    xs = [torch.from_numpy(x) for x in _inputs(seed=1)]
    kernels.reset_launch_counts()
    got = K.paged_decode_attention(*xs, scale=0.25, softcap=50.0, window=9)
    torch.testing.assert_close(got, paged_decode_plain(*xs, scale=0.25, softcap=50.0, window=9), rtol=0, atol=0)
    assert kernels.launch_counts()["paged_attention"] == 0


# ---------------------------------------------------------------------------
# the wrapper's CUDA branch, driven on the CPU through a launcher stand-in
# ---------------------------------------------------------------------------


def _fake_launch(family, name, device, *args):
    assert (family, name) == ("paged_attention", "decode")
    (q, kp, vp, tables, lens, out, part, b, kv, n_rep, hd, page, nb, splits, scale, softcap, window, code, start,
     lse) = args
    assert all(isinstance(v, int) for v in (b, kv, n_rep, hd, page, nb, splits, window, code, start))
    assert isinstance(scale, float) and isinstance(softcap, float)
    # enough CHUNK-row splits for the most live rows a slot can hold, and the
    # partial states' scratch exactly where there is more than one
    rows = min(nb * page, window) if window else nb * page
    assert splits == K.split_count(nb, page, window) and (splits - 1) * K.CHUNK < rows <= splits * K.CHUNK
    if splits == 1:
        assert part is None
    else:
        assert part.dtype == torch.float32 and part.is_contiguous()
        assert part.shape == (b * kv * splits * n_rep * (hd + 2),)
    assert q.dtype == torch.float32 and q.shape == (b, kv * n_rep, hd) and q.is_contiguous()
    assert kp.dtype == vp.dtype == {0: torch.float32, 1: torch.bfloat16}[code]
    assert kp.shape == vp.shape and kp.shape[1:] == (page, kv, hd) and kp.is_contiguous() and vp.is_contiguous()
    assert tables.dtype == lens.dtype == torch.int32 and tables.shape == (b, nb) and lens.shape == (b,)
    assert tables.is_contiguous() and lens.is_contiguous()
    assert out.dtype == torch.float32 and out.shape == q.shape
    kw = dict(scale=scale, softcap=softcap, window=window, start=start)
    if lse is None:
        out.copy_(paged_decode_plain(q, kp, vp, tables, lens, **kw))
    else:
        assert lse.dtype == torch.float32 and lse.shape == q.shape[:2] and lse.is_contiguous()
        got, got_lse = paged_decode_plain(q, kp, vp, tables, lens, return_lse=True, **kw)
        out.copy_(got)
        lse.copy_(got_lse)
    return True  # launched: the wrapper counts it


@pytest.fixture
def cuda_branch(monkeypatch):
    """Route the wrapper into its CUDA branch with the stand-in launcher."""
    monkeypatch.setattr(K, "route", lambda *xs: "cuda")
    monkeypatch.setattr(build, "launch", _fake_launch)
    kernels.reset_launch_counts()
    yield
    kernels.reset_launch_counts()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_branch_takes_kernel_layouts(cuda_branch, dtype):
    q, kp, vp, bt, lens = (torch.from_numpy(x) for x in _inputs(seed=2))
    kp, vp = kp.to(dtype), vp.to(dtype)
    got = K.paged_decode_attention(q, kp, vp, bt, lens, scale=0.25, softcap=50.0, window=9)
    torch.testing.assert_close(got, paged_decode_plain(q, kp, vp, bt, lens, scale=0.25, softcap=50.0, window=9))
    assert kernels.launch_counts()["paged_attention"] == 1
    assert kernels.backward_launch_counts()["paged_attention"] == 0
    with pytest.raises(TypeError, match="int32"):
        K.paged_decode_attention(q, kp, vp, bt.long(), lens, scale=0.25)
    with pytest.raises(ValueError, match="contiguous"):
        K.paged_decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1), kp, vp, bt, lens, scale=0.25)
    with pytest.raises(TypeError, match="dtype"):
        K.paged_decode_attention(q, kp.half(), vp.half(), bt, lens, scale=0.25)
    assert kernels.launch_counts()["paged_attention"] == 1


@pytest.mark.parametrize(
    "nb,page,window,splits",
    [(4, 8, 9, 1), (32, 8, 0, 1), (33, 8, 0, 2), (70, 8, 0, 3), (264, 16, 4096, 16), (264, 16, 0, 17),
     (512, 16, 4096, 16), (52, 5, 300, 2), (3, 16, 4096, 1)],
)
def test_cuda_branch_splits_long_tables_with_scratch(cuda_branch, nb, page, window, splits):
    """A table wider than one chunk (or a window that is) gets S > 1 splits
    and their scratch; the result is the plain version's, one launch."""
    q, kp, vp, _, _ = (torch.from_numpy(x) for x in _inputs(seed=3))
    rng = np.random.default_rng(nb + page)
    bt = torch.from_numpy(rng.integers(1, kp.shape[0], (3, nb)).astype(np.int32))
    lens = torch.tensor([1, nb * page // 2 + 1, nb * page], dtype=torch.int32)
    assert K.split_count(nb, page, window) == splits
    got = K.paged_decode_attention(q, kp, vp, bt, lens, scale=0.25, softcap=30.0, window=window)
    torch.testing.assert_close(got, paged_decode_plain(q, kp, vp, bt, lens, scale=0.25, softcap=30.0, window=window))
    assert kernels.launch_counts()["paged_attention"] == 1


def test_split_count_reads_no_lengths(cuda_branch, monkeypatch):
    """The wrapper picks S from NB, page, window and CHUNK alone: lengths on
    the meta device (no values to read: a host read would raise) launch with
    the same S as any real lengths, and S is the ceiling of the live-row
    bound over CHUNK for every size."""
    seen = []
    monkeypatch.setattr(build, "launch", lambda family, name, device, *args: seen.append(args[13]))
    q = torch.from_numpy(_inputs(seed=4)[0])
    for nb, page, window in [(4, 8, 0), (70, 8, 0), (70, 8, 300), (600, 1, 7), (264, 16, 4096)]:
        bt = torch.ones((3, nb), dtype=torch.int32)
        kp = vp = torch.zeros(2, page, 2, 16)
        real = torch.tensor([1, 2, nb * page], dtype=torch.int32)
        for lens in (torch.empty(3, dtype=torch.int32, device="meta"), real):
            K.paged_decode_attention(q, kp, vp, bt, lens, scale=0.25, window=window)
        rows = min(nb * page, window) if window else nb * page
        assert seen[-2] == seen[-1] == K.split_count(nb, page, window) == -(-rows // K.CHUNK)
    for nb in range(1, 40):
        for page in (1, 5, 16):
            for window in (0, 1, 255, 256, 257, 4096):
                s = K.split_count(nb, page, window)
                rows = min(nb * page, window) if window else nb * page
                assert s * K.CHUNK >= rows and (s - 1) * K.CHUNK < rows


def _merge_chunks(q, kp, vp, bt, lens, *, scale, softcap, window, chunk):
    """The kernel's two passes over the plain masked softmax, in float32:
    chunk c of a slot holds the live rows [lo + c chunk, lo + (c + 1) chunk),
    its state (m, l, A) over those rows alone (M = -1e30, L = 0, A = 0 where
    it holds none), then M = max m_c, L = sum l_c e^(m_c - M) and
    out = sum A_c e^(m_c - M) / max(L, 1e-30), c in order."""
    b, h, hd = q.shape
    kv = kp.shape[2]
    n_rep = h // kv
    kd = kp[bt.long()].reshape(b, -1, kv, hd).float().repeat_interleave(n_rep, dim=2)
    vd = vp[bt.long()].reshape(b, -1, kv, hd).float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), kd) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    out = torch.empty(b, h, hd)
    n_chunks = -(-(min(kd.shape[1], window) if window else kd.shape[1]) // chunk)
    for i in range(b):
        n = int(lens[i])
        lo = max(n - window, 0) if window else 0
        states = []
        for c in range(n_chunks):
            r0, r1 = lo + c * chunk, min(lo + (c + 1) * chunk, n)
            if r0 >= r1:
                states.append((torch.full((h,), -1e30), torch.zeros(h), torch.zeros(h, hd)))
                continue
            sc = s[i, :, r0:r1]
            m = sc.amax(-1)
            p = torch.exp(sc - m[:, None])
            states.append((m, p.sum(-1), torch.einsum("ht,thd->hd", p, vd[i, r0:r1])))
        big = torch.stack([m for m, _, _ in states]).amax(0)
        total, acc = torch.zeros(h), torch.zeros(h, hd)
        for m, l_c, a_c in states:
            wt = torch.exp(m - big)
            total = total + l_c * wt
            acc = acc + a_c * wt[:, None]
        out[i] = acc / torch.clamp(total, min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("softcap,window", CASES + [(50.0, 40)])
@pytest.mark.parametrize("chunk", [4, 7, 256])
def test_chunked_merge_equals_plain_softmax(softcap, window, chunk):
    """The combine identity the split kernel rests on: merging per-chunk
    softmax states, with empty chunks in short slots (and a window that
    starts mid-chunk), gives the plain masked softmax within 1e-6."""
    xs = [torch.from_numpy(x) for x in _inputs(seed=5, b=4, nb=8, lens=(1, 17, 33, 64))]
    kw = dict(scale=0.25, softcap=softcap, window=window)
    want = paged_decode_plain(*xs, **kw)
    got = _merge_chunks(*xs, chunk=chunk, **kw)
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-6)


def test_paged_engine_kernel_route_launches_once_per_layer_per_tick(cuda_branch):
    """The paged engine on the kernel route (stand-in launcher): the tokens
    equal the plain (gather) route's and every decode tick launches the
    kernel once per layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ContinuousLMEngine
    from repro_torch.serve.service import LMService

    cfg = get_config("gemma2-2b").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    spec = [(rng.integers(0, cfg.vocab_size, s).astype(np.int32), m) for s, m in [(4, 5), (13, 8), (1, 4), (7, 7)]]
    outs, ticks = {}, {}
    for impl in ("kernel", "plain"):
        eng = ContinuousLMEngine(cfg, params, n_slots=2, max_len=32, max_prompt_len=16,
                                 paged=True, page_size=8, impl=impl, device="cpu")
        svc = LMService(eng).warmup()
        kernels.reset_launch_counts()
        futs = [svc.submit(t, m) for t, m in spec]
        svc.drain()
        outs[impl] = [f.result(timeout=30) for f in futs]
        ticks[impl] = (eng.pool.steps, kernels.launch_counts()["paged_attention"])
    assert ticks["kernel"][1] == cfg.n_layers * ticks["kernel"][0] > 0
    assert ticks["plain"][1] == 0
    for a, b in zip(outs["kernel"], outs["plain"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# a cache split by sequence: blocks with their start and log-sum-exp
# ---------------------------------------------------------------------------


def _dense(seed, b, h, kv, hd, length):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, length, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, length, kv, hd)).astype(np.float32)
    return q, k, v


def _blocks_merged(q, k, v, lens, blocks, **kw):
    """Each block of rows a one-page-a-slot pool with its start and LSE,
    merged; and the blocks' LSEs."""
    b, length = k.shape[:2]
    rows = length // blocks
    table = torch.arange(b, dtype=torch.int32)[:, None]
    outs, lses = [], []
    for i in range(blocks):
        out, lse = paged_decode_plain(q, k[:, i * rows:(i + 1) * rows].contiguous(),
                                      v[:, i * rows:(i + 1) * rows].contiguous(), table, lens,
                                      start=i * rows, return_lse=True, **kw)
        outs.append(out)
        lses.append(lse)
    return merge_partials(torch.stack(outs), torch.stack(lses)), torch.stack(lses)


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (50.0, 0), (30.0, 12), (50.0, 20)],
                         ids=["global", "global-capped", "window12", "window20"])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2)], ids=["nrep1", "nrep2"])
@pytest.mark.parametrize("blocks", [2, 4])
def test_blocks_with_start_and_lse_merge_to_the_reference(softcap, window, h, kv, blocks):
    """Blocks of a 32-row cache (8 or 16 rows each): lengths 1 (every later
    block empty), 8, 9, 17, 30 and 32, windows that end a slot's live rows
    inside a later block than they start; the merge equals the reference's
    Pallas kernel over the whole cache (pages of 8 rows) and its model's
    ``_decode_attention``, and an empty block gives out 0 and LSE -inf."""
    from repro.models.attention import _decode_attention
    from repro.models.common import BlockSpec

    lens_np = np.array([1, 8, 9, 17, 30, 32], np.int32)
    b, hd, length = len(lens_np), 16, 32
    q, k, v = _dense(7, b, h, kv, hd, length)
    kw = dict(scale=0.25, softcap=softcap, window=window)
    lens = torch.from_numpy(lens_np)
    got, lses = _blocks_merged(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), lens, blocks, **kw)

    page = 8
    pages = lambda x: jnp.asarray(x.reshape(b * length // page, page, kv, hd))  # noqa: E731
    table = jnp.asarray(np.arange(b * length // page, dtype=np.int32).reshape(b, length // page))
    want = np.asarray(paged_decode_kernel_call(jnp.asarray(q), pages(k), pages(v), table, jnp.asarray(lens_np), **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)

    cfg = type("Cfg", (), dict(attn_scale=0.25, attn_softcap=softcap or None, window_size=window))()
    spec = BlockSpec(mixer="attn", attn_type="local" if window else "global")
    dec = _decode_attention(jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens_np), cfg, spec)
    np.testing.assert_allclose(got.numpy(), np.asarray(dec)[:, 0], rtol=0, atol=1e-5)

    # the slot of length 1 has no live row past the first block
    rows = length // blocks
    empty = torch.isinf(lses)
    assert bool(empty[1:, 0].all()) and not bool(empty[0, 0].any())
    start = torch.arange(blocks)[:, None] * rows
    live_lo = (lens - window).clamp(min=0) if window else torch.zeros_like(lens)
    assert torch.equal(empty.all(-1), (start >= lens) | (start + rows <= live_lo))


def test_block_at_start_zero_without_lse_is_the_whole_plain_version():
    """``start`` 0 and no LSE: the same numbers as before, bit for bit; a
    block's output and LSE agree with one softmax over its own rows."""
    xs = [torch.from_numpy(x) for x in _inputs(seed=6)]
    kw = dict(scale=0.25, softcap=50.0, window=9)
    base = paged_decode_plain(*xs, **kw)
    assert torch.equal(paged_decode_plain(*xs, start=0, **kw), base)
    out, lse = paged_decode_plain(*xs, return_lse=True, **kw)
    assert torch.equal(out, base)
    q, kp, vp, bt, lens = xs
    kd = kp[bt.long()].reshape(3, -1, 2, 16).repeat_interleave(2, dim=2)
    s = 50.0 * torch.tanh(torch.einsum("bhd,bthd->bht", q, kd) * 0.25 / 50.0)
    t = torch.arange(kd.shape[1])
    live = (t[None] < lens[:, None]) & (t[None] >= lens[:, None] - 9)
    want = torch.logsumexp(torch.where(live[:, None], s, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)


def test_cuda_branch_passes_start_and_the_lse_buffer(cuda_branch):
    q, k, v = (torch.from_numpy(x) for x in _dense(8, 3, 4, 2, 16, 32))
    lens = torch.tensor([1, 17, 32], dtype=torch.int32)
    table = torch.arange(3, dtype=torch.int32)[:, None]
    kb, vb = k[:, 16:].contiguous(), v[:, 16:].contiguous()
    kw = dict(scale=0.25, softcap=30.0, window=20, start=16)
    got, lse = K.paged_decode_attention(q, kb, vb, table, lens, return_lse=True, **kw)
    want, want_lse = paged_decode_plain(q, kb, vb, table, lens, return_lse=True, **kw)
    assert torch.equal(got, want) and torch.equal(lse, want_lse)
    assert kernels.launch_counts()["paged_attention"] == 1
    with pytest.raises(ValueError, match="start"):
        K.paged_decode_attention(q, kb, vb, table, lens, scale=0.25, start=-1)
