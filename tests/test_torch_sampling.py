"""The port's host-side sampling against the reference.

``serve/sampling.py`` is a copy that draws from numpy's ``Generator``, so
the same logits and seeds give the same tokens in both packages:
``sample_token`` is replayed draw by draw on seeded logits, then the
sampling engine (at temperature 0 it is the greedy engine, at temperature
0.8 / top-k 8 it draws per-request streams) serves the reference's mix on
reduced gemma2-2b with the reference's weights, and its tokens are held
against the reference's ``ContinuousLMEngine(sampling=True)``.
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
from repro.serve import sampling as ref_sampling  # noqa: E402
from repro.train.serve import greedy_generate as ref_greedy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve import sampling  # noqa: E402
from repro_torch.serve.engine import ContinuousLMEngine  # noqa: E402
from repro_torch.serve.service import LMService  # noqa: E402

SPEC = [(4, 5), (9, 3), (13, 8), (24, 2), (1, 4), (7, 7)]


@pytest.mark.parametrize(
    "temperature,top_k,seed",
    [(0.0, None, None), (0.8, 50, 0), (0.8, 8, 7), (1.3, None, 3), (5.0, 2, 11), (0.7, 1, 5), (0.5, 0, 2)],
)
def test_sample_token_draws_equal_the_reference(temperature, top_k, seed):
    """Draw after draw from one stream per package, over seeded (V,) logits
    rows of a wide vocabulary: the same tokens."""
    rng = np.random.default_rng(123)
    rows = rng.standard_normal((40, 4096)).astype(np.float32) * 3.0
    p = sampling.SamplingParams(temperature=temperature, top_k=top_k, seed=seed).validate()
    rp = ref_sampling.SamplingParams(temperature=temperature, top_k=top_k, seed=seed).validate()
    assert p.greedy == rp.greedy
    g, rg = sampling.make_rng(p, 17), ref_sampling.make_rng(rp, 17)
    assert (g is None) == (rg is None) == p.greedy
    got = [sampling.sample_token(r, p, g) for r in rows]
    want = [ref_sampling.sample_token(r, rp, rg) for r in rows]
    assert got == want
    if p.greedy:
        assert got == [int(np.argmax(r)) for r in rows]


def test_sample_token_unit_and_validation():
    """The reference's ``TestSampling`` unit cases, on the port."""
    logits = np.asarray([0.1, 3.0, -1.0, 2.9], np.float32)
    assert sampling.sample_token(logits, None, None) == 1
    assert sampling.sample_token(logits, sampling.GREEDY, None) == 1
    p1 = sampling.SamplingParams(temperature=0.7, top_k=1, seed=0)
    assert sampling.sample_token(logits, p1, sampling.make_rng(p1, 0)) == 1  # top-1 == argmax
    pk = sampling.SamplingParams(temperature=5.0, top_k=2, seed=0)
    rng = sampling.make_rng(pk, 0)
    assert {sampling.sample_token(logits, pk, rng) for _ in range(64)} == {1, 3}
    with pytest.raises(ValueError, match="temperature"):
        sampling.SamplingParams(temperature=-1.0).validate()
    with pytest.raises(ValueError, match="top_k"):
        sampling.SamplingParams(top_k=-2).validate()
    # an unpinned seed falls back to the admission counter
    a = sampling.make_rng(sampling.SamplingParams(temperature=1.0), 9)
    b = ref_sampling.make_rng(ref_sampling.SamplingParams(temperature=1.0), 9)
    assert a.integers(0, 1 << 30) == b.integers(0, 1 << 30)


@pytest.fixture(scope="module")
def gemma():
    """Reduced gemma2-2b with the reference's weights in both frameworks and
    the reference's SPEC prompts."""
    rcfg = ref_config("gemma2-2b").reduced()
    cfg = get_config("gemma2-2b").reduced()
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    rng = np.random.default_rng(0)
    spec = [(rng.integers(0, cfg.vocab_size, s).astype(np.int32), m) for s, m in SPEC]
    return cfg, params, rcfg, rparams, spec


def _serve(engine_cls, service_cls, cfg, params, spec, submit_kw=None, **engine_kw):
    eng = engine_cls(cfg, params, n_slots=4, max_len=48, max_prompt_len=24, **engine_kw)
    svc = service_cls(eng)
    svc.warmup()
    futs = [svc.submit(t, m, **(submit_kw(i) if submit_kw else {})) for i, (t, m) in enumerate(spec)]
    svc.drain()
    return [np.asarray(f.result(timeout=60)) for f in futs]


def _port(cfg, params, spec, **kw):
    return _serve(ContinuousLMEngine, LMService, cfg, params, spec, device="cpu", **kw)


def _ref(rcfg, rparams, spec, **kw):
    return _serve(RefEngine, RefService, rcfg, rparams, spec, **kw)


@pytest.mark.parametrize("engine_kw", [{}, dict(paged=True, page_size=8)], ids=["dense", "paged8"])
def test_sampling_engine_at_temperature_zero_is_greedy(gemma, engine_kw):
    """``sampling=True`` returns logits rows to the host; greedy requests
    take their argmax — the reference's ``greedy_generate`` tokens."""
    cfg, params, rcfg, rparams, spec = gemma
    outs = _port(cfg, params, spec, sampling=True, **engine_kw)
    for (t, m), o in zip(spec, outs):
        want = np.asarray(ref_greedy(rparams, rcfg, jnp.asarray(t[None]), m, max_len=48))[0]
        np.testing.assert_array_equal(o, want)


@pytest.mark.parametrize(
    "engine_kw,submit",
    [
        (dict(paged=True, page_size=16), dict(temperature=0.8, top_k=8)),
        ({}, dict(temperature=1.1)),
        (dict(paged=True, page_size=8, prefill_chunk=8), dict(temperature=0.8, top_k=8)),
    ],
    ids=["paged16-topk8", "dense-fullvocab", "paged8-chunked"],
)
def test_sampled_tokens_equal_the_reference_per_seed(gemma, engine_kw, submit):
    """Per-request seeds: the port's sampled tokens equal the reference
    sampling engine's, reproduce on a rerun, and leave greedy somewhere."""
    cfg, params, rcfg, rparams, spec = gemma
    kw = lambda i: dict(submit, seed=100 + i)  # noqa: E731
    a = _port(cfg, params, spec, submit_kw=kw, sampling=True, **engine_kw)
    b = _port(cfg, params, spec, submit_kw=kw, sampling=True, **engine_kw)
    want = _ref(rcfg, rparams, spec, submit_kw=kw, sampling=True, **engine_kw)
    for x, y, w in zip(a, b, want):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, w)
    greedy = _port(cfg, params, spec, **engine_kw)
    assert any(not np.array_equal(x, g) for x, g in zip(a, greedy))


def test_unpinned_seeds_follow_the_admission_counter(gemma):
    """Requests without a seed draw from the pool's admission counter: the
    same tokens as the reference, request for request."""
    cfg, params, rcfg, rparams, spec = gemma
    kw = lambda i: dict(temperature=0.9, top_k=16)  # noqa: E731
    got = _port(cfg, params, spec, submit_kw=kw, sampling=True, paged=True, page_size=16)
    want = _ref(rcfg, rparams, spec, submit_kw=kw, sampling=True, paged=True, page_size=16)
    for x, w in zip(got, want):
        np.testing.assert_array_equal(x, w)


def test_greedy_engine_rejects_temperature(gemma):
    cfg, params, _, _, _ = gemma
    svc = LMService(ContinuousLMEngine(cfg, params, n_slots=2, max_len=32, max_prompt_len=16, device="cpu"))
    with pytest.raises(ValueError, match="sampling=True"):
        svc.submit(np.zeros(4, np.int32), 2, temperature=0.8)
    with pytest.raises(ValueError, match="temperature"):
        svc.submit(np.zeros(4, np.int32), 2, temperature=-0.5)
    # temperature 0 with a seed is still greedy, and admitted
    svc.submit(np.zeros(4, np.int32), 2, seed=3)
    svc.drain()
