"""The port's continuous-batching LM serving against the reference.

Port ``ContinuousLMEngine`` + ``LMService`` (dense, and paged at page 8 and
16, and a pool too small for the whole mix so admission defers) serve the
reference's ``SPEC`` mix (``tests/test_paging.py``) on reduced gemma2-2b
with the reference's weights; every request's tokens must equal the
reference's whole-request ``greedy_generate``, with the page metrics that
``TestPagedMatchesDense`` checks.  Then the in-flight probe against its
oracle, the whole-request engine, request validation and the CLI smoke.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.decorr.probe import slot_probe_rows as ref_slot_probe_rows  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.serve.engine import LMServeEngine as RefLMServeEngine  # noqa: E402
from repro.train.serve import greedy_generate as ref_greedy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.decorr.config import DecorrConfig  # noqa: E402
from repro_torch.decorr.probe import slot_probe_rows  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve.engine import ContinuousLMEngine, LMServeEngine  # noqa: E402
from repro_torch.serve.loadgen import lm_probe_oracle_err  # noqa: E402
from repro_torch.serve.probes import DecorrProbe  # noqa: E402
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


@pytest.fixture(scope="module")
def gemma():
    """Reduced gemma2-2b, the reference's weights in both frameworks, the
    SPEC prompts and the reference's greedy tokens (max_len 48)."""
    rcfg = ref_config("gemma2-2b").reduced()
    cfg = get_config("gemma2-2b").reduced()
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    rng = np.random.default_rng(0)
    spec = [(rng.integers(0, cfg.vocab_size, s).astype(np.int32), m) for s, m in SPEC]
    steps = RefLMServeEngine(rcfg).steps  # one decode compile for the whole mix
    want = [np.asarray(ref_greedy(rparams, rcfg, jnp.asarray(t[None]), m, max_len=48, steps=steps))[0]
            for t, m in spec]
    return cfg, params, spec, want


def _serve(cfg, params, spec, probe=None, record=False, **engine_kw):
    eng = ContinuousLMEngine(cfg, params, n_slots=4, max_len=48, max_prompt_len=24, device="cpu", **engine_kw)
    svc = LMService(eng, probe=probe, record_probe_rows=record).warmup()
    futs = [svc.submit(t, m) for t, m in spec]
    svc.drain()
    return [f.result(timeout=30) for f in futs], svc


@pytest.mark.parametrize(
    "engine_kw",
    [{}, dict(paged=True, page_size=16), dict(paged=True, page_size=8), dict(paged=True, page_size=8, total_pages=11)],
    ids=["dense", "paged16", "paged8-compaction", "paged8-small-pool"],
)
def test_tokens_equal_reference_greedy(gemma, engine_kw):
    cfg, params, spec, want = gemma
    outs, svc = _serve(cfg, params, spec, **engine_kw)
    for w, o in zip(want, outs):
        np.testing.assert_array_equal(o, w)
    m = svc.metrics()
    assert m["dispatch_errors"] == 0 and m["slots_retired_total"] == len(spec)
    if not engine_kw:
        return
    assert 0 < m["paged_peak_cache_bytes"] < m["paged_dense_equiv_bytes"]
    assert m["paged_pages_in_use"] == 0.0 and m["paged_pages_reserved"] == 0.0
    if engine_kw["page_size"] == 8 and "total_pages" not in engine_kw:
        assert m["paged_pages_compaction_moves"] > 0
    if "total_pages" in engine_kw:
        # 10 usable pages of 8 tokens, far below 4 slots x 48 rows: requests
        # queue behind the page reservation instead of running out of pages
        assert m["paged_pages_peak"] <= 10


def test_probe_matches_its_oracle_under_paging(gemma):
    cfg, params, spec, _ = gemma
    probe = DecorrProbe(DecorrConfig(style="vic", reg="sum", q=2), device="cpu")
    _, svc = _serve(cfg, params, spec, probe=probe, record=True, paged=True, page_size=16)
    assert probe.steps >= 1
    err = lm_probe_oracle_err(svc)
    assert err is not None and err < 1e-3
    pool = svc.engine.pool
    assert sum(r.shape[0] for r in svc.probe_rows) == pool.admitted_total + pool.active_slot_steps


def test_slot_probe_rows_matches_the_reference():
    hidden = np.random.default_rng(0).standard_normal((4, 6)).astype(np.float32)
    for active in ([0, 2, 3], [], [1]):
        want = ref_slot_probe_rows(hidden, active)
        np.testing.assert_array_equal(slot_probe_rows(torch.from_numpy(hidden), active).numpy(), want)


def test_whole_request_engine_matches_reference_greedy(gemma):
    cfg, params, spec, want = gemma
    eng = LMServeEngine(cfg, "cpu")
    for (t, m), w in zip(spec[:3], want[:3]):
        np.testing.assert_array_equal(eng.generate(params, torch.from_numpy(t[None]), m, max_len=48)[0].numpy(), w)


def test_requests_are_validated_and_later_options_raise(gemma):
    cfg, params, _, _ = gemma
    eng = ContinuousLMEngine(cfg, params, n_slots=2, max_len=32, max_prompt_len=16, paged=True, page_size=8,
                             total_pages=3, device="cpu")
    svc = LMService(eng)
    with pytest.raises(ValueError, match="empty prompt"):
        svc.submit(np.zeros((0,), np.int32), 4)
    with pytest.raises(ValueError, match="largest prompt bucket"):
        svc.submit(np.zeros((17,), np.int32), 4)
    with pytest.raises(ValueError, match="slot cache"):
        svc.submit(np.zeros((16,), np.int32), 18)
    with pytest.raises(ValueError, match="pages"):
        svc.submit(np.zeros((16,), np.int32), 10)  # 25 rows = 4 pages > 2 usable
    # the reference's gating errors: chunked prefill, the prefix cache and
    # speculation ride the paged pool, chunk_all the chunk step, and
    # speculation is greedy-only
    for kw, match in (
        (dict(prefill_chunk=8), "paged"), (dict(prefix_cache=True), "paged"), (dict(speculative=True), "paged"),
        (dict(chunk_all=True), "chunk_all"), (dict(paged=True, speculative=True, sampling=True), "greedy"),
    ):
        with pytest.raises(ValueError, match=match):
            ContinuousLMEngine(cfg, params, device="cpu", **kw)


def test_engines_run_on_cuda_unless_cpu_is_asked(gemma):
    """No device named means ``cuda`` (without CUDA the engine raises, and
    never serves CPU params quietly); params on another device raise."""
    cfg, params, _, _ = gemma
    prompt = torch.zeros((1, 4), dtype=torch.int32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ContinuousLMEngine(cfg, params, n_slots=2, max_len=32, max_prompt_len=16)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LMServeEngine(cfg)
    else:
        with pytest.raises(ValueError, match="engine runs on cuda"):
            ContinuousLMEngine(cfg, params, n_slots=2, max_len=32, max_prompt_len=16)
        with pytest.raises(ValueError, match="engine runs on cuda"):
            LMServeEngine(cfg).generate(params, prompt, 2)
    meta = dict(params, embed=params["embed"].to("meta"))
    with pytest.raises(ValueError, match="engine runs on cpu"):
        ContinuousLMEngine(cfg, meta, n_slots=2, max_len=32, max_prompt_len=16, device="cpu")
    with pytest.raises(ValueError, match="engine runs on cpu"):
        LMServeEngine(cfg, "cpu").generate(meta, prompt, 2)


def test_cli_lm_smoke_on_cpu(capsys):
    from repro_torch.serve import cli

    args = ["--smoke", "--lm-arch", "gemma2-2b", "--continuous", "--paged", "--block-size", "16"]
    assert cli.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "healthy=True" in out and "token mismatches: 0" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(args)
    # the whole-request path (``make_prompt`` + ``timed_generate``)
    assert cli.main(["--lm-arch", "gemma2-2b", "--max-batch", "2", "--new-tokens", "3", "--device", "cpu"]) == 0
    assert "tok/s" in capsys.readouterr().out


def test_threaded_loop_serves_and_beats(gemma):
    """``start`` / ``stop``: the tick loop on its thread serves every
    request (the reference's tokens) and keeps the heartbeat fresh."""
    cfg, params, spec, want = gemma
    eng = ContinuousLMEngine(cfg, params, n_slots=2, max_len=48, max_prompt_len=24, paged=True, page_size=8,
                             device="cpu")
    svc = LMService(eng).warmup().start()
    try:
        futs = [svc.submit(t, m) for t, m in spec[:3]]
        outs = [f.result(timeout=60) for f in futs]
    finally:
        svc.stop(timeout=30)
    assert svc._thread is None
    for w, o in zip(want, outs):
        np.testing.assert_array_equal(o, w)
    m = svc.metrics()
    assert m["heartbeat_stale"] == 0 and m["tokens_total"] == sum(len(o) for o in outs)
    assert all(f.ttft_s is not None and 0 < f.ttft_s <= f.latency_s for f in futs)


def test_cli_chunked_prefix_speculative_and_sampling_flags_on_cpu(capsys):
    """``--prefill-chunk``, ``--prefix-cache``, ``--speculative`` and
    ``--temperature`` / ``--top-k`` each run their comparison under
    ``--smoke``; the prefix cache and speculation need ``--paged``."""
    from repro_torch.serve import cli

    args = ["--smoke", "--lm-arch", "gemma2-2b", "--continuous", "--paged", "--block-size", "16",
            "--prefill-chunk", "16", "--prefix-cache", "--speculative", "--draft-k", "4",
            "--temperature", "0.8", "--top-k", "8", "--device", "cpu"]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "healthy=True" in out
    for line in ("[serve] chunked prefill (16 tokens a tick)", "[serve] prefix cache:", "[serve] speculative:",
                 "reproducible=True"):
        assert line in out, line
    assert out.count("token mismatches: 0") >= 4
    for flag in ("--prefix-cache", "--speculative"):
        with pytest.raises(SystemExit):
            cli.main(["--smoke", "--lm-arch", "gemma2-2b", "--continuous", flag, "--device", "cpu"])
