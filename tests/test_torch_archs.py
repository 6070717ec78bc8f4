"""The nine LM archs beyond gemma2-2b — dense variants (codeqwen1.5-7b,
qwen1.5-110b, nemotron-4-340b), M-RoPE (qwen2-vl-2b), MoE (arctic-480b,
llama4-scout), Mamba + MoE (jamba), RWKV6 (rwkv6-3b) and audio codes
(musicgen-large) — through the port against the reference, at
``reduced()`` widths with the reference's own weights (``params_from_jax``):

  * the score forward: logits within 1e-4 x max(1, max |ref|), hidden
    states within 1e-5, the MoE aux loss within 1e-5;
  * prefill, then one decode step: logits, and every attention cache and
    recurrent state leaf within 1e-5 x max(1, max |ref|);
  * serving: ``ContinuousLMEngine`` + ``LMService`` tokens on the
    reference's ``SPEC`` mix equal to the reference engine's, dense and, where
    the reference pages, paged (the reference holds its paged tokens equal
    to its dense ones); musicgen's ``LMServeEngine.generate`` codes equal
    to the reference's;
  * every refusal where the reference refuses: paging an attention-free
    pattern, chunked prefill or speculation on a recurrent one, continuous
    batching of audio codes;

and qwen2-vl through ``embeds=`` with three different M-RoPE streams.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.models.transformer import forward as ref_forward_eager  # noqa: E402
from repro.models.transformer import init_caches as ref_init_caches  # noqa: E402
from repro.serve.engine import ContinuousLMEngine as RefEngine  # noqa: E402
from repro.serve.engine import LMServeEngine as RefLMServeEngine  # noqa: E402
from repro.serve.service import LMService as RefService  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import forward, init_caches, params_from_jax  # noqa: E402
from repro_torch.serve.engine import ContinuousLMEngine, LMServeEngine  # noqa: E402
from repro_torch.serve.service import LMService  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (see tests/test_torch_lm_train.py):
    under the parallel test workers torch's default pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SPEC = [(4, 5), (9, 3), (13, 8), (24, 2), (1, 4), (7, 7)]
# the reference's forward compiled whole (one compile a shape, not one an
# op): the same computation, a fraction of the test's time
ref_forward = jax.jit(ref_forward_eager, static_argnums=1)
ARCHS = [a for a in list_archs() if a != "gemma2-2b"]
HIDDEN_TOL = 1e-5
ENGINE = dict(n_slots=4, max_len=48, max_prompt_len=24)


def _logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-4 * max(1.0, float(np.abs(want).max())))


def _close(got, want, atol=HIDDEN_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _caches_close(got, want):
    """Every cache and state leaf within 1e-5 x max(1, max |ref|): the
    deeper stacks (jamba's 16 layers) and the recurrent state, which sums
    over every position so far, carry values of a few units."""
    for name, leafs in got.items():
        for key, leaf in leafs.items():
            ref = np.asarray(want[name][key])
            _close(leaf.numpy(), ref, atol=HIDDEN_TOL * max(1.0, float(np.abs(ref).max())))


def _tokens(cfg, rng, shape):
    if cfg.frontend == "audio_codes":
        shape = shape + (cfg.n_codebooks,)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(reference config, port config, reference params, port params) of
    one arch at ``reduced()`` widths."""
    rcfg = ref_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, rparams, params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")


def test_the_registry_is_the_references():
    assert list_archs() == ref_list_archs()
    for name in list_archs():
        cfg, rcfg = get_config(name), ref_config(name)
        assert (cfg.param_count(), cfg.active_param_count()) == (rcfg.param_count(), rcfg.active_param_count())
        assert cfg.reduced().param_count() == rcfg.reduced().param_count()


def test_score_forward(arch):
    rcfg, cfg, rparams, params = arch
    toks = _tokens(cfg, np.random.default_rng(0), (2, 12))
    want = ref_forward(rparams, rcfg, tokens=jnp.asarray(toks))
    got = forward(params, cfg, torch.from_numpy(toks))
    _logits_close(got.logits.numpy(), want.logits)
    _close(got.hidden.numpy(), want.hidden)
    _close(float(got.aux["moe_aux"]), float(want.aux["moe_aux"]))


def test_prefill_then_decode(arch):
    rcfg, cfg, rparams, params = arch
    toks = _tokens(cfg, np.random.default_rng(1), (2, 12))
    rc = ref_init_caches(rcfg, 2, 16)
    caches = init_caches(cfg, 2, 16, "cpu")
    rpre = ref_forward(rparams, rcfg, tokens=jnp.asarray(toks[:, :11]), caches=rc, cache_len=jnp.asarray(0, jnp.int32))
    pre = forward(params, cfg, torch.from_numpy(toks[:, :11]), caches=caches, cache_len=0)
    _logits_close(pre.logits.numpy(), rpre.logits)
    rdec = ref_forward(rparams, rcfg, tokens=jnp.asarray(toks[:, 11:]), caches=rpre.caches,
                       cache_len=jnp.asarray(11, jnp.int32))
    dec = forward(params, cfg, torch.from_numpy(toks[:, 11:]), caches=caches, cache_len=11)
    _logits_close(dec.logits.numpy(), rdec.logits)
    _caches_close(dec.caches, rdec.caches)


def _serve(engine_cls, service_cls, cfg, params, spec, engine=ENGINE, **kw):
    svc = service_cls(engine_cls(cfg, params, **engine, **kw))
    svc.warmup(prompt_lens=[len(t) for t, _ in spec])
    futs = [svc.submit(t, m) for t, m in spec]
    svc.drain()
    return [np.asarray(f.result(timeout=60)) for f in futs], svc


def test_serving_matches_the_reference_engine(arch):
    """Token archs: the port's continuous engine, dense and paged (page 8,
    so compaction moves pages; jamba's Mamba state stays per slot beside
    them), against the reference's continuous engine on ``SPEC``.  musicgen:
    ``LMServeEngine.generate`` against the reference's."""
    rcfg, cfg, rparams, params = arch
    rng = np.random.default_rng(0)
    if cfg.frontend == "audio_codes":
        prompt = _tokens(cfg, rng, (2, 9))
        want = RefLMServeEngine(rcfg).generate(rparams, jnp.asarray(prompt), 6)
        got = LMServeEngine(cfg, "cpu").generate(params, torch.from_numpy(prompt), 6)
        assert got.shape == (2, 6, cfg.n_codebooks)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    spec = [(_tokens(cfg, rng, (s,)), m) for s, m in SPEC]
    want, _ = _serve(RefEngine, RefService, rcfg, rparams, spec)
    layouts = [{}] if cfg.is_attention_free else [{}, dict(paged=True, page_size=8)]
    for kw in layouts:
        got, svc = _serve(ContinuousLMEngine, LMService, cfg, params, spec, device="cpu", **kw)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        assert svc.engine.pad_prompts == all(b.mixer == "attn" for b in cfg.pattern)
        m = svc.metrics()
        assert m["dispatch_errors"] == 0 and m["slots_retired_total"] == len(spec)
        if kw:
            assert m["paged_pages_in_use"] == 0.0 and m["paged_pages_reserved"] == 0.0


def test_jamba_decode_drops_at_eight_slots_follow_the_reference_per_layout():
    """Eight slots and capacity factor 0.5: a decode tick's 16 top-2 picks
    over 4 experts of 4 seats each drop tokens, and the free lanes take
    seats too.  The dense and the paged pool feed the router different
    free-lane rows (a dense lane's own stale rows, a paged lane's sentinel
    page), so the reference's own dense and paged tokens differ; the port's
    equal the reference's in each layout."""
    rcfg = ref_config("jamba-v0.1-52b").reduced(capacity_factor=0.5)
    cfg = get_config("jamba-v0.1-52b").reduced(capacity_factor=0.5)
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    rng = np.random.default_rng(0)
    spec = [(_tokens(cfg, rng, (s,)), m) for s, m in [(4, 6), (9, 5), (4, 8), (9, 3), (4, 7), (9, 6), (4, 5), (9, 9)]]
    engine = dict(n_slots=8, max_len=32, max_prompt_len=9)
    paged = dict(paged=True, page_size=8)
    ref_dense, _ = _serve(RefEngine, RefService, rcfg, rparams, spec, engine)
    ref_paged, _ = _serve(RefEngine, RefService, rcfg, rparams, spec, engine, **paged)
    assert any(not np.array_equal(a, b) for a, b in zip(ref_dense, ref_paged))
    for want, kw in ((ref_dense, {}), (ref_paged, paged)):
        got, _ = _serve(ContinuousLMEngine, LMService, cfg, params, spec, engine, device="cpu", **kw)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


OPTIONS = {
    "dense": {},
    "paged": dict(paged=True, page_size=8),
    "chunked": dict(paged=True, page_size=8, prefill_chunk=8),
    "speculative": dict(paged=True, page_size=8, speculative=True),
}
# what the reference refuses: paging an attention-free pattern, chunked
# prefill and speculation on a recurrent one, any continuous audio engine
REFUSED = {
    "rwkv6-3b": {"paged", "chunked", "speculative"},
    "jamba-v0.1-52b": {"chunked", "speculative"},
    "musicgen-large": set(OPTIONS),
}


def test_refusals_match_the_reference(arch):
    """Each engine option raises in the port exactly where it raises in the
    reference, with the same exception type."""
    rcfg, cfg, rparams, params = arch
    refused = set()
    for name, kw in OPTIONS.items():
        try:
            RefEngine(rcfg, rparams, **ENGINE, **kw)
        except (ValueError, NotImplementedError) as e:
            refused.add(name)
            with pytest.raises(type(e)):
                ContinuousLMEngine(cfg, params, **ENGINE, device="cpu", **kw)
        else:
            ContinuousLMEngine(cfg, params, **ENGINE, device="cpu", **kw)
    assert refused == REFUSED.get(cfg.name, set())


def test_qwen2_vl_embeds_with_three_position_streams():
    """The vision stub: precomputed embeddings and (3, B, S) M-RoPE streams
    that differ from each other (temporal / height / width), through the
    score forward and through prefill + decode."""
    rcfg = ref_config("qwen2-vl-2b").reduced()
    cfg = get_config("qwen2-vl-2b").reduced()
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    rng = np.random.default_rng(5)
    b, s = 2, 10
    embeds = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32) * 0.5
    base = np.arange(s)
    pos = np.stack([np.broadcast_to(base, (b, s)), np.broadcast_to(base // 3, (b, s)),
                    np.broadcast_to(base % 4 + 2, (b, s))]).astype(np.int32)
    assert not (np.array_equal(pos[0], pos[1]) or np.array_equal(pos[1], pos[2]))
    want = ref_forward(rparams, rcfg, embeds=jnp.asarray(embeds), positions=jnp.asarray(pos))
    got = forward(params, cfg, embeds=torch.from_numpy(embeds), positions=torch.from_numpy(pos))
    _logits_close(got.logits.numpy(), want.logits)
    _close(got.hidden.numpy(), want.hidden)
    # the streams matter: one shared stream gives other logits
    flat = forward(params, cfg, embeds=torch.from_numpy(embeds), positions=torch.from_numpy(pos[:1].repeat(3, 0)))
    assert not np.allclose(flat.logits.numpy(), got.logits.numpy())
    rc = ref_init_caches(rcfg, b, 16)
    caches = init_caches(cfg, b, 16, "cpu")
    rpre = ref_forward(rparams, rcfg, embeds=jnp.asarray(embeds[:, :-1]), positions=jnp.asarray(pos[:, :, :-1]),
                       caches=rc, cache_len=jnp.asarray(0, jnp.int32))
    forward(params, cfg, embeds=torch.from_numpy(embeds[:, :-1]), positions=torch.from_numpy(pos[:, :, :-1]),
            caches=caches, cache_len=0)
    rdec = ref_forward(rparams, rcfg, embeds=jnp.asarray(embeds[:, -1:]), positions=jnp.asarray(pos[:, :, -1:]),
                       caches=rpre.caches, cache_len=jnp.asarray(s - 1, jnp.int32))
    dec = forward(params, cfg, embeds=torch.from_numpy(embeds[:, -1:]), positions=torch.from_numpy(pos[:, :, -1:]),
                  caches=caches, cache_len=s - 1)
    _logits_close(dec.logits.numpy(), rdec.logits)
    # the last row of the score forward is the decode step's
    _logits_close(dec.logits[:, 0].numpy(), want.logits[:, -1])


def test_rwkv_chunked_prefill_through_the_model():
    """``reduced(rwkv_chunk=8)``: a 24-token prompt prefills through the
    chunk-parallel path, a 20-token one through the scan; both match the
    reference's prefill and its carried state, and the chunked logits stay
    within the reference's bound (1e-4 of the largest) of the scan's."""
    rcfg = ref_config("rwkv6-3b").reduced(rwkv_chunk=8)
    cfg = get_config("rwkv6-3b").reduced(rwkv_chunk=8)
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    toks = _tokens(cfg, np.random.default_rng(2), (1, 24))
    for s in (24, 20):
        rc = ref_init_caches(rcfg, 1, 32)
        caches = init_caches(cfg, 1, 32, "cpu")
        want = ref_forward(rparams, rcfg, tokens=jnp.asarray(toks[:, :s]), caches=rc,
                           cache_len=jnp.asarray(0, jnp.int32))
        got = forward(params, cfg, torch.from_numpy(toks[:, :s]), caches=caches, cache_len=0)
        _logits_close(got.logits.numpy(), want.logits)
        _caches_close(got.caches, want.caches)
    seq = forward(params, dataclasses.replace(cfg, rwkv_chunk=None), torch.from_numpy(toks)).logits.numpy()
    chunked = forward(params, cfg, torch.from_numpy(toks)).logits.numpy()
    assert np.abs(chunked - seq).max() < 1e-4 * np.abs(seq).max()
