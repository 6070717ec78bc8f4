"""The port's chunked prefill against the reference.

Two chunked paths: the long-prompt (flash-style) prefill, an online softmax
over the causal chunk pairs that ``models/attention._chunked_attention``
takes for a prompt above ``attn_chunk_threshold`` (lowered here to 16 with
chunks of 8, on reduced gemma2-2b, so a 32-token prompt takes it), and the
serving engine's incremental prefill (``prefill_chunk``), whose chunks
attend across the rows already written (``_offset_prefill_attention``).
Both are held against the reference functions on the same seeded inputs at
the reference's 5e-4 tolerance, and the engines' tokens against the
reference engine's on its ``SPEC`` mix (exact).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.models.transformer import forward as ref_forward  # noqa: E402
from repro.models.transformer import init_caches as ref_init_caches  # noqa: E402
from repro.serve import ContinuousLMEngine as RefEngine  # noqa: E402
from repro.serve import LMService as RefService  # noqa: E402
from repro.serve.slots import LMRequest as RefRequest  # noqa: E402
from repro.serve.slots import SlotPool as RefPool  # noqa: E402
from repro.train.serve import greedy_generate as ref_greedy  # noqa: E402
from repro.train.serve import make_chunked_prefill_step as ref_chunk_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.models.transformer import forward, init_caches  # noqa: E402
from repro_torch.serve.engine import ContinuousLMEngine  # noqa: E402
from repro_torch.serve.service import LMService  # noqa: E402
from repro_torch.serve.slots import LMRequest, SlotPool  # noqa: E402
from repro_torch.train.serve import make_chunked_prefill_step  # noqa: E402

# the reference's tolerance for the chunked path (tests/test_models_smoke.py)
TOL = 5e-4
SPEC = [(4, 5), (9, 3), (13, 8), (24, 2), (1, 4), (7, 7)]
LOW = dict(attn_chunk_threshold=16, attn_chunk_size=8)


@pytest.fixture(scope="module")
def gemma():
    """Reduced gemma2-2b (chunk threshold 16, chunks of 8) with the
    reference's weights in both frameworks, and the SPEC prompts."""
    rcfg = dataclasses.replace(ref_config("gemma2-2b").reduced(), **LOW)
    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(), **LOW)
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    rng = np.random.default_rng(0)
    spec = [(rng.integers(0, cfg.vocab_size, s).astype(np.int32), m) for s, m in SPEC]
    return cfg, params, rcfg, rparams, spec


def _qkv(s, h=4, kv=2, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, s, n, hd)).astype(np.float32) * g for n, g in ((h, 3.0), (kv, 3.0), (kv, 1.0))]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("attn_type", ["local", "global"])
@pytest.mark.parametrize("s", [24, 32, 48])
def test_chunked_attention_matches_the_reference(gemma, attn_type, s):
    """The online softmax over causal chunk pairs (with the local window's
    pair span) against the reference's scan, and against the port's own
    full attention; scores are scaled x 3 so the softcap of 50 acts."""
    cfg, _, rcfg, _, _ = gemma
    spec = next(b for b in cfg.pattern if b.attn_type == attn_type)
    rspec = next(b for b in rcfg.pattern if b.attn_type == attn_type)
    q, k, v = _qkv(s, seed=s)
    got = attn._chunked_attention(*(torch.from_numpy(x) for x in (q, k, v)), cfg, spec, 8)
    want = ref_attn._chunked_attention(*(jnp.asarray(x) for x in (q, k, v)), rcfg, rspec, 8)
    _close(got.numpy(), want, tol=1e-5)
    full = attn._full_attention(*(torch.from_numpy(x) for x in (q, k, v)), cfg, spec)
    _close(got.numpy(), full.numpy(), tol=1e-5)


@pytest.mark.parametrize("attn_type", ["local", "global"])
@pytest.mark.parametrize("offset", [0, 8, 21])
def test_offset_prefill_attention_matches_the_reference(gemma, attn_type, offset):
    """A chunk of 8 queries at rows [offset, offset + 8) over a 48-row cache
    (rows past the chunk hold other values, masked)."""
    cfg, _, rcfg, _, _ = gemma
    spec = next(b for b in cfg.pattern if b.attn_type == attn_type)
    rspec = next(b for b in rcfg.pattern if b.attn_type == attn_type)
    q = _qkv(8, seed=offset)[0]
    _, ck, cv = _qkv(48, seed=offset + 1)
    got = attn._offset_prefill_attention(torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
                                         offset, cfg, spec)
    want = ref_attn._offset_prefill_attention(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), offset, rcfg, rspec)
    _close(got.numpy(), want, tol=1e-5)


@pytest.mark.parametrize("s", [32, 40])
def test_long_prompt_forward_matches_the_reference(gemma, s):
    """A prompt above the lowered threshold (a multiple of the chunk) runs
    the whole stack through ``_chunked_attention``: logits and the prefilled
    cache rows against the reference's forward, and logits against the
    port's own forward with the chunked path bypassed."""
    cfg, params, rcfg, rparams, _ = gemma
    toks = np.random.default_rng(s).integers(0, cfg.vocab_size, (1, s)).astype(np.int32)
    caches = init_caches(cfg, 1, 48, "cpu")
    got = forward(params, cfg, torch.from_numpy(toks), caches=caches, cache_len=0)
    want = ref_forward(rparams, rcfg, tokens=jnp.asarray(toks), caches=ref_init_caches(rcfg, 1, 48),
                       cache_len=jnp.asarray(0, jnp.int32))
    _close(got.logits.numpy(), want.logits)
    for name in caches:
        for key in ("k", "v"):
            _close(caches[name][key][:, :, :s].numpy(), np.asarray(want.caches[name][key])[:, :, :s])
    full_cfg = dataclasses.replace(cfg, attn_chunk_threshold=1 << 30)
    full = forward(params, full_cfg, torch.from_numpy(toks))
    _close(got.logits.numpy(), full.logits.numpy(), tol=1e-5)


def test_chunk_steps_match_the_reference(gemma):
    """``make_chunked_prefill_step``: a 21-token prompt in chunks of 8 (the
    last right-padded) written into a batch-1 template at offsets 0, 8, 16;
    every chunk's last-row logits and hidden row, and the written rows."""
    cfg, params, rcfg, rparams, _ = gemma
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, 21).astype(np.int32)
    step, rstep = make_chunked_prefill_step(cfg), jax.jit(ref_chunk_step(rcfg))
    caches, rcaches = init_caches(cfg, 1, 48, "cpu"), ref_init_caches(rcfg, 1, 48)
    for off in (0, 8, 16):
        take = min(8, 21 - off)
        padded = np.zeros((1, 8), np.int32)
        padded[0, :take] = toks[off:off + take]
        logits, hidden, caches = step(params, caches, torch.from_numpy(padded), off, take - 1)
        rlogits, rhidden, rcaches = rstep(rparams, rcaches, jnp.asarray(padded), np.int32(off), np.int32(take - 1))
        _close(logits.numpy(), rlogits)
        _close(hidden.numpy(), rhidden)
    for name in caches:
        _close(caches[name]["k"][:, :, :21].numpy(), np.asarray(rcaches[name]["k"])[:, :, :21])


def _serve(engine_cls, service_cls, cfg, params, spec, max_len=48, max_prompt=24, **engine_kw):
    eng = engine_cls(cfg, params, n_slots=4, max_len=max_len, max_prompt_len=max_prompt, **engine_kw)
    svc = service_cls(eng)
    svc.warmup()
    futs = [svc.submit(t, m) for t, m in spec]
    svc.drain()
    return [np.asarray(f.result(timeout=60)) for f in futs], svc


@pytest.mark.parametrize(
    "engine_kw",
    [dict(paged=True, page_size=8, prefill_chunk=8), dict(paged=True, page_size=16, prefill_chunk=4, chunk_all=True),
     dict(paged=True, page_size=8, prefill_chunk=8, total_pages=11)],
    ids=["chunk8", "chunk4-all", "chunk8-small-pool"],
)
def test_chunked_engine_tokens_equal_the_reference(gemma, engine_kw):
    """Chunked serving prefill on the SPEC mix: the port's tokens equal the
    reference chunked engine's and its whole-request greedy tokens; chunk
    steps interleave with decode ticks."""
    cfg, params, rcfg, rparams, spec = gemma
    outs, svc = _serve(ContinuousLMEngine, LMService, cfg, params, spec, device="cpu", **engine_kw)
    want, _ = _serve(RefEngine, RefService, rcfg, rparams, spec, **engine_kw)
    for (t, m), o, w in zip(spec, outs, want):
        np.testing.assert_array_equal(o, w)
        np.testing.assert_array_equal(o, np.asarray(ref_greedy(rparams, rcfg, jnp.asarray(t[None]), m, max_len=48))[0])
    m = svc.metrics()
    assert m["dispatch_errors"] == 0 and m["paged_pages_in_use"] == 0 and m["paged_pages_reserved"] == 0
    # slots chunk-prefilling held a lane without decoding in it
    assert m["slots_occupancy"] < 1.0


def test_long_prompts_through_the_service_match_the_reference(gemma):
    """Prompts of 25-32 tokens land in the 32-token bucket, above the
    lowered threshold: the engine's prefill runs ``_chunked_attention``.
    Tokens equal the reference engine's and the port's with the chunked
    path bypassed."""
    cfg, params, rcfg, rparams, _ = gemma
    rng = np.random.default_rng(9)
    spec = [(rng.integers(0, cfg.vocab_size, s).astype(np.int32), m) for s, m in [(25, 6), (32, 4), (30, 9), (7, 5)]]
    kw = dict(max_len=64, max_prompt=40, paged=True, page_size=8)
    outs, _ = _serve(ContinuousLMEngine, LMService, cfg, params, spec, device="cpu", **kw)
    want, _ = _serve(RefEngine, RefService, rcfg, rparams, spec, **kw)
    full_cfg = dataclasses.replace(cfg, attn_chunk_threshold=1 << 30)
    full, _ = _serve(ContinuousLMEngine, LMService, full_cfg, params, spec, device="cpu", **kw)
    for o, w, f in zip(outs, want, full):
        np.testing.assert_array_equal(o, w)
        np.testing.assert_array_equal(o, f)


def test_slot_pool_bookkeeping_matches_the_reference():
    """Still-prefilling slots: cache length 0, out of ``decoding_indices``,
    not counted by ``observe_step``; the admission counter seeds streams."""
    pools = (SlotPool(3, 32), RefPool(3, 32))
    reqs = [(np.arange(n, dtype=np.int32), 4) for n in (5, 12, 9)]
    for pool, req_cls in zip(pools, (LMRequest, RefRequest)):
        slots = [pool.admit(req_cls(t, m), None) for t, m in reqs]
        slots[1].prefill_pos = 4  # chunk-prefilling
        pool.observe_step()
        slots[0].emit(3)
    (a, b) = pools
    assert a.decoding_indices() == b.decoding_indices() == [0, 2]
    np.testing.assert_array_equal(a.cache_lens(), b.cache_lens())
    np.testing.assert_array_equal(a.last_tokens(), b.last_tokens())
    assert a.metrics() == b.metrics()
    assert [a[i].prefilling for i in range(3)] == [b[i].prefilling for i in range(3)] == [False, True, False]


def test_gating_and_abort(gemma):
    """The reference's gating ``ValueError``s, and a failed chunked prefill
    dropping its live work tree and the slot's pages."""
    cfg, params, _, _, _ = gemma
    with pytest.raises(ValueError, match="paged"):
        ContinuousLMEngine(cfg, params, n_slots=2, max_len=32, prefill_chunk=8, device="cpu")
    with pytest.raises(ValueError, match="chunk_all"):
        ContinuousLMEngine(cfg, params, n_slots=2, max_len=32, chunk_all=True, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        ContinuousLMEngine(cfg, params, n_slots=2, max_len=32, paged=True, prefill_chunk=-1, device="cpu")
    with pytest.raises(ValueError, match="template rows"):
        ContinuousLMEngine(cfg, params, n_slots=2, max_len=32, max_prompt_len=31, paged=True, page_size=8,
                           prefill_chunk=24, device="cpu")
    eng = ContinuousLMEngine(cfg, params, n_slots=2, max_len=48, max_prompt_len=24, paged=True, page_size=8,
                             prefill_chunk=8, device="cpu")
    eng.warmup()
    slot = eng.pool.admit(LMRequest(np.zeros(20, np.int32), 4), None)
    eng.admit_slot(slot)
    assert slot.prefilling and eng.needs_chunking(20) and not eng.needs_chunking(8)
    assert eng.advance_prefill(slot) is None  # first chunk: the tree is live
    assert eng._chunk_live == slot.index and eng.prefilling_slot() is slot
    eng.abort_slot(slot.index)
    eng.pool.retire(slot.index)
    assert eng._chunk_live is None
    assert eng.pager.alloc.reserved_total == 0 and eng.pager.alloc.in_use == 0
