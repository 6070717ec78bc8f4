"""The paged-attention kernel's plain version against the reference kernel,
and the wrapper's CUDA branch driven on the CPU.

The port's ``paged_decode_plain`` (the CPU route and the on-card yardstick
of ``csrc/paged_attention.cu``) is held against the reference's
``paged_decode_jnp`` and its Pallas kernel ``paged_decode_attention`` (in
interpret mode on the CPU) at ``tests/test_paging.py``'s shapes and its four
(softcap, window) cases, atol 1e-5.  A stand-in for the CUDA launcher then
routes the wrapper into its CUDA branch on the CPU, checks every operand
the kernel would get against its layout rule (f32 q, page dtype, int32
tables and lengths, contiguity, the C argument list) and counts the
launches, alone and inside the paged engine.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import ops as rops  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as K  # noqa: E402
from repro_torch.kernels.paged_attention.ops import paged_decode_plain  # noqa: E402

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
    q, kp, vp, tables, lens, out, b, kv, n_rep, hd, page, nb, scale, softcap, window, code = args
    assert all(isinstance(v, int) for v in (b, kv, n_rep, hd, page, nb, window, code))
    assert isinstance(scale, float) and isinstance(softcap, float)
    assert q.dtype == torch.float32 and q.shape == (b, kv * n_rep, hd) and q.is_contiguous()
    assert kp.dtype == vp.dtype == {0: torch.float32, 1: torch.bfloat16}[code]
    assert kp.shape == vp.shape and kp.shape[1:] == (page, kv, hd) and kp.is_contiguous() and vp.is_contiguous()
    assert tables.dtype == lens.dtype == torch.int32 and tables.shape == (b, nb) and lens.shape == (b,)
    assert tables.is_contiguous() and lens.is_contiguous()
    assert out.dtype == torch.float32 and out.shape == q.shape
    out.copy_(paged_decode_plain(q, kp, vp, tables, lens, scale=scale, softcap=softcap, window=window))


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
