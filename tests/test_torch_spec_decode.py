"""The port's speculative decoding against the reference.

The n-gram drafter, the draft budget and the acceptance rule are copies
and must answer the same on the same contexts; the manager's scratch-page
lifecycle (begin / commit / rollback) must leave the same tables and
scratch inventory; the verify step (the decode step at the lane-batched
shape, lanes of a slot sharing one scratch-mapped table row and seeing the
rows earlier lanes wrote) must give the reference's logits on the same
pool; and end to end the speculative engine's tokens equal plain greedy
decoding, the reference's ``greedy_generate`` and the reference's
speculative engine, with the same speculation counters (exact on the CPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.serve import ContinuousLMEngine as RefEngine  # noqa: E402
from repro.serve import LMService as RefService  # noqa: E402
from repro.serve import spec as ref_spec  # noqa: E402
from repro.serve.paging import PagedKVManager as RefManager  # noqa: E402
from repro.train import serve as ref_serve  # noqa: E402
from repro.train.serve import greedy_generate as ref_greedy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve import spec  # noqa: E402
from repro_torch.serve.engine import ContinuousLMEngine  # noqa: E402
from repro_torch.serve.loadgen import LMLoadConfig, compare_speculative  # noqa: E402
from repro_torch.serve.paging import PagedKVManager  # noqa: E402
from repro_torch.serve.service import LMService  # noqa: E402
from repro_torch.train import serve  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (see tests/test_torch_lm_train.py):
    under the parallel test workers torch's default pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# the reference's decode-heavy mix (tests/test_spec_decode.py)
SPEC = [(4, 12), (9, 8), (13, 8), (24, 6), (1, 10), (7, 7)]


@pytest.mark.parametrize("ngram", [(1, 3), (2, 2), (1, 1)])
def test_drafter_proposes_like_the_reference(ngram):
    """Random contexts over small alphabets (so n-grams recur): every
    propose(k), k = 0..5, after every push gives the same draft and the
    same counters."""
    cfg = spec.SpecConfig(draft_k=4, ngram_min=ngram[0], ngram_max=ngram[1])
    rcfg = ref_spec.SpecConfig(draft_k=4, ngram_min=ngram[0], ngram_max=ngram[1])
    rng = np.random.default_rng(sum(ngram))
    for alphabet in (3, 6):
        prompt = rng.integers(0, alphabet, 7).tolist()
        d, rd = spec.SlotDraft(cfg, prompt), ref_spec.SlotDraft(rcfg, prompt)
        for step in range(60):
            k = step % 6
            assert d.propose(k) == rd.propose(k)
            tok = int(rng.integers(0, alphabet))
            d.push(tok)
            rd.push(tok)
            d.observe_accept(step % 3)
            rd.observe_accept(step % 3)
        assert (d.drafts, d.draft_hits, d.proposed_total, d.accepted_total, d.hit_rate) == (
            rd.drafts, rd.draft_hits, rd.proposed_total, rd.accepted_total, rd.hit_rate)
        assert d.draft_hits > 0


def test_budget_acceptance_and_stats_match_the_reference():
    rng = np.random.default_rng(1)
    for _ in range(200):
        k, max_new, emitted = (int(x) for x in rng.integers(0, 12, 3))
        assert spec.draft_budget(k, max_new, emitted) == ref_spec.draft_budget(k, max_new, emitted)
        proposed = rng.integers(0, 3, int(rng.integers(0, 6))).tolist()
        outputs = rng.integers(0, 3, len(proposed) + 1).tolist()
        assert spec.accept_length(proposed, outputs) == ref_spec.accept_length(proposed, outputs)
    counts = dict(verify_steps=7, plain_steps=2, tokens_emitted=20, tokens_proposed=18, tokens_accepted=9,
                  drafts=11, draft_hits=8, rejects=4, slot_lanes=14)
    assert spec.SpecStats(**counts).metrics() == ref_spec.SpecStats(**counts).metrics()
    assert spec.SpecStats().metrics() == ref_spec.SpecStats().metrics()
    for bad in (dict(draft_k=0), dict(ngram_min=0), dict(ngram_min=3, ngram_max=2)):
        with pytest.raises(ValueError):
            spec.SpecConfig(**bad)


@pytest.fixture(scope="module")
def gemma():
    rcfg = ref_config("gemma2-2b").reduced()
    cfg = get_config("gemma2-2b").reduced()
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [(rng.integers(0, cfg.vocab_size, s).astype(np.int32), m) for s, m in SPEC]
    return cfg, params, rcfg, rparams, prompts


@pytest.mark.parametrize("page,draft_k", [(8, 4), (4, 4), (16, 2)])
def test_scratch_lifecycle_matches_the_reference(gemma, page, draft_k):
    """Random verify windows on two slots: spec_begin's remapped rows and
    boundary copies, then a commit of a random accepted prefix or a
    rollback — the same tables, scratch inventory and allocator state."""
    cfg, _, rcfg, _, _ = gemma
    mgrs = (PagedKVManager(cfg, 2, 48, page, spec_draft_k=draft_k), RefManager(rcfg, 2, 48, page, spec_draft_k=draft_k))
    for m in mgrs:
        m.admit(0, 10, 36)
        m.admit(1, 3, 36)
    rng = np.random.default_rng(page + draft_k)
    pos = {0: 10, 1: 3}
    for step in range(30):
        slot = step % 2
        if pos[slot] + draft_k + 1 > 38:
            continue
        for m in mgrs:
            m.ensure_rows(slot, pos[slot])
        k = int(rng.integers(1, draft_k + 1))
        opened = [m.spec_begin(slot, pos[slot], k) for m in mgrs]
        (t, c), (rt, rc) = opened
        assert (t.blocks, t.scratch, c) == (rt.blocks, rt.scratch, rc)
        np.testing.assert_array_equal(t.row, rt.row)
        if step % 5 == 4:
            for m, tk in zip(mgrs, (t, rt)):
                m.spec_rollback(tk)
        else:
            a = int(rng.integers(0, k + 1))
            for m, tk in zip(mgrs, (t, rt)):
                m.spec_commit(tk, a + 1)
            pos[slot] += a + 1
        np.testing.assert_array_equal(mgrs[0].block_tables(), mgrs[1].block_tables())
        assert mgrs[0]._spec_free == mgrs[1]._spec_free
        assert mgrs[0].alloc.metrics() == mgrs[1].alloc.metrics()
    assert mgrs[0].metrics() == mgrs[1].metrics()


def test_verify_step_matches_the_reference_at_the_lane_batched_shape(gemma):
    """Two slots x (draft_k + 1) = 10 lanes: slot 0's five lanes share one
    table row at positions 13..17 and each reads the rows the lanes before
    it wrote in the same call; slot 1 rides lane 0 only; free lanes sit on
    the sentinel.  Logits, hidden rows and the written pool rows against the
    reference's verify step on the same random pool."""
    cfg, params, rcfg, rparams, _ = gemma
    page, width = 8, 5
    mgr = PagedKVManager(cfg, 2, 48, page)
    pool = mgr.init_caches("cpu")
    rng = np.random.default_rng(3)
    for leafs in pool.values():
        for t in leafs.values():
            t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32) * 0.5))
    rpool = {n: {k: jnp.asarray(v.numpy()) for k, v in leafs.items()} for n, leafs in pool.items()}
    tables = np.zeros((2 * width, mgr.blocks_per_slot), np.int32)
    tables[:width, :3] = [4, 9, 2]
    tables[width, :2] = [7, 5]
    lens = np.zeros((2 * width,), np.int32)
    lens[:width] = 13 + np.arange(width)
    lens[width] = 11
    toks = rng.integers(0, cfg.vocab_size, 2 * width).astype(np.int32)
    seq = {n: {k: v.clone() for k, v in leafs.items()} for n, leafs in pool.items()}
    logits, hidden, pool = serve.make_verify_step(cfg, return_hidden=True)(
        params, pool, torch.from_numpy(lens), torch.from_numpy(toks)[:, None],
        block_tables=torch.from_numpy(tables), impl="plain")
    rlogits, rhidden, rpool = jax.jit(ref_serve.make_verify_step(rcfg, return_hidden=True))(
        rparams, rpool, jnp.asarray(lens), tokens=jnp.asarray(toks)[:, None], block_tables=jnp.asarray(tables))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(rhidden), rtol=2e-4, atol=2e-4)
    for name in pool:
        for key in ("k_pages", "v_pages"):
            got, want = pool[name][key].numpy(), np.asarray(rpool[name][key])
            np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=2e-4, atol=2e-4)  # page 0: the sentinel
    # each lane of slot 0 equals a one-token decode, in turn, from the pool
    # as it was before the verify
    step = serve.make_decode_step(cfg, return_hidden=True)
    for j in range(width):
        lg, _, seq = step(params, seq, torch.tensor([int(lens[j])]), torch.tensor([[int(toks[j])]]),
                          block_tables=torch.from_numpy(tables[j:j + 1]), impl="plain")
        np.testing.assert_allclose(lg[0].numpy(), logits[j].numpy(), rtol=1e-5, atol=1e-5)


def _serve(engine_cls, service_cls, cfg, params, prompts, **engine_kw):
    eng = engine_cls(cfg, params, n_slots=4, max_len=48, max_prompt_len=24, **engine_kw)
    svc = service_cls(eng)
    svc.warmup()
    futs = [svc.submit(t, m) for t, m in prompts]
    svc.drain()
    return [np.asarray(f.result(timeout=60)) for f in futs], svc


@pytest.mark.parametrize("page,draft_k", [(8, 4), (16, 2), (4, 3)])
def test_speculative_tokens_equal_plain_greedy_and_the_reference(gemma, page, draft_k):
    """Speculative == plain paged greedy == the reference's greedy_generate
    == the reference's speculative engine, with the same speculation
    counters; every page accounted for after retirement, scratch intact."""
    cfg, params, rcfg, rparams, prompts = gemma
    kw = dict(paged=True, page_size=page)
    outs, svc = _serve(ContinuousLMEngine, LMService, cfg, params, prompts, device="cpu", speculative=True,
                       draft_k=draft_k, **kw)
    plain, _ = _serve(ContinuousLMEngine, LMService, cfg, params, prompts, device="cpu", **kw)
    want, rsvc = _serve(RefEngine, RefService, rcfg, rparams, prompts, speculative=True, draft_k=draft_k, **kw)
    for (t, m), o, p, w in zip(prompts, outs, plain, want):
        np.testing.assert_array_equal(o, p)
        np.testing.assert_array_equal(o, w)
        np.testing.assert_array_equal(o, np.asarray(ref_greedy(rparams, rcfg, jnp.asarray(t[None]), m, max_len=48))[0])
    m, rm = svc.metrics(), rsvc.metrics()
    for key in ("spec_verify_steps", "spec_plain_steps", "spec_tokens_emitted", "spec_tokens_proposed",
                "spec_tokens_accepted", "spec_rejects", "slots_decode_steps", "paged_pages_peak"):
        assert m[key] == rm[key], key
    assert m["spec_verify_steps"] > 0 and m["spec_tokens_accepted"] > 0
    assert m["paged_pages_in_use"] == m["paged_spec_scratch_pages"] == m["paged_spec_scratch_free"]
    assert m["paged_pages_reserved"] == 0.0


def test_speculation_with_chunked_prefill_and_the_probe(gemma):
    """Speculation beside chunk-prefilling slots (which sit out the verify on
    sentinel lanes), and one probe row per emitted token."""
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.serve.loadgen import lm_probe_oracle_err
    from repro_torch.serve.probes import DecorrProbe

    cfg, params, rcfg, rparams, prompts = gemma
    kw = dict(paged=True, page_size=8, prefill_chunk=8)
    eng = ContinuousLMEngine(cfg, params, n_slots=4, max_len=48, max_prompt_len=24, device="cpu",
                             speculative=True, **kw)
    probe = DecorrProbe(DecorrConfig(style="vic", reg="sum", q=2), device="cpu")
    svc = LMService(eng, probe=probe, record_probe_rows=True).warmup()
    futs = [svc.submit(t, m) for t, m in prompts]
    svc.drain()
    want, _ = _serve(RefEngine, RefService, rcfg, rparams, prompts, **kw)
    for f, w in zip(futs, want):
        np.testing.assert_array_equal(f.result(timeout=60), w)
    fed = sum(r.shape[0] for r in svc.probe_rows)
    assert fed == sum(m for _, m in prompts)  # one row per emitted token
    err = lm_probe_oracle_err(svc)
    assert err is not None and err < 1e-3


def test_gating_requires_paged_greedy(gemma):
    cfg, params, _, _, _ = gemma
    with pytest.raises(ValueError, match="paged"):
        ContinuousLMEngine(cfg, params, n_slots=2, max_len=32, max_prompt_len=16, speculative=True, device="cpu")
    with pytest.raises(ValueError, match="greedy"):
        ContinuousLMEngine(cfg, params, n_slots=2, max_len=32, max_prompt_len=16, paged=True, page_size=8,
                           speculative=True, sampling=True, device="cpu")
    with pytest.raises(ValueError, match="draft_k"):
        ContinuousLMEngine(cfg, params, n_slots=2, max_len=32, max_prompt_len=16, paged=True, page_size=8,
                           speculative=True, draft_k=0, device="cpu")


def test_compare_speculative_on_the_cli_mix(gemma):
    """``loadgen.compare_speculative`` on the reference CLI's decode-heavy
    mix: identical tokens and more than one token a verify slot-lane."""
    cfg, params, _, _, _ = gemma
    load = LMLoadConfig(n_requests=8, prompt_lens=(4, 6, 8), new_tokens=(24, 32))
    g = compare_speculative(cfg, params, load, n_slots=4, page_size=16, draft_k=4, device="cpu")["gate"]
    assert g["token_mismatches"] == 0 and g["tokens_per_lane"] > 1 and g["accepted_tokens_per_step"] > 1
