"""The port's tuner (``repro_torch.tune``, ``decorr.warmup``,
``auto_page_size``) against the reference's ``repro.tune``, on the CPU.

Twins of ``tests/test_tune.py``'s space, cache, dispatch-precedence, tuner,
CLI and plan tests (round trip, schema, corrupt file, concurrent stores,
memo hit, disk hit, override beats cache, illegal or wrong-key entry,
guard default, dry determinism, measure times each candidate once,
analytic pre-tune writes the cache, ``jobs_for`` searches b when unpinned)
under the port's rules: Hopper legality (shared memory, threads), one
config a tile kernel, exact shapes as keys, the backend ``torch-cpu``.
Parity with the reference:

* the four-step plan picks for d in {2048, 8192, 2039, 2304, 5120};
* ``jobs_for(n, d, block_size=128)``'s job list, shape for shape;
* ``auto_page_size`` on four pool shapes and ``tests/test_paging.py``'s case;
* ``warmup_tune_cache``'s shapes for ``local`` / ``global`` / ``tp`` meshes.
The grouped plan is charged the port's padding, not TPU lanes: its picks
are the port's own (pinned below).
"""

import json
import threading
import types

import pytest

torch = pytest.importorskip("torch")

from repro import tune as ref_tune  # noqa: E402
from repro.decorr import DecorrConfig as RefDecorrConfig  # noqa: E402
from repro.decorr import warmup_tune_cache as ref_warmup  # noqa: E402
from repro.kernels.paged_attention.ops import auto_page_size as ref_auto_page_size  # noqa: E402
from repro.tune.cli import jobs_for as ref_jobs_for  # noqa: E402
from repro_torch import tune  # noqa: E402
from repro_torch.core import regularizers as regs  # noqa: E402
from repro_torch.decorr import DecorrConfig, mesh_parallelism, shard_local_shape, warmup_tune_cache  # noqa: E402
from repro_torch.kernels.paged_attention.ops import PAGE_PREFER, auto_page_size  # noqa: E402
from repro_torch.kernels.sumvec_fft import ops as fops  # noqa: E402
from repro_torch.tune import cache as tcache  # noqa: E402
from repro_torch.tune import cost as tcost  # noqa: E402
from repro_torch.tune import dispatch as tdispatch  # noqa: E402
from repro_torch.tune import space as tspace  # noqa: E402
from repro_torch.tune import tuner as ttuner  # noqa: E402
from repro_torch.tune.cli import jobs_for  # noqa: E402

SHAPES = {
    "xcorr_offdiag": (24, 200),
    "cmatmul": (40, 24, 72),
    "pmatmul": (40, 24, 72),
    "ctwiddle": (24, 200),
    "freq_outer": (9, 48, 24),
    "freq_mat": (9, 48, 24, 24),
    "sumvec_fft_plan": (101,),
    "grouped_block_plan": (24, 48),
    "paged_attention": (4, 48, 2, 16),
}
PLAN_DS = (2048, 8192, 2039, 2304, 5120)
PLAN_PICKS = {2048: (2048, 32, 64), 8192: (8192, 64, 128), 2039: (4080, 60, 68), 2304: (2304, 48, 48),
              5120: (5120, 64, 80)}
POOLS = ((8, 48, 2, 16), (8, 4352, 4, 256), (8, 2048, 8, 128), (40, 4352, 4, 256))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (see tests/test_torch_lm_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    """Every test: a cache directory of its own (for both packages) and an
    empty memo before and after, so no pick reaches another test."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "cache"))
    tdispatch.clear_memory_cache()
    ref_tune.clear_memory_cache()
    yield
    tdispatch.clear_memory_cache()
    ref_tune.clear_memory_cache()


# ---------------------------------------------------------------------------
# Candidate spaces
# ---------------------------------------------------------------------------


class TestSpace:
    @pytest.mark.parametrize("kernel", tspace.KERNELS)
    def test_candidates_nonempty_and_legal(self, kernel):
        shape = SHAPES[kernel]
        cands = tspace.candidates(kernel, shape)
        assert cands
        for cfg in cands:
            assert tspace.is_legal(kernel, shape, cfg), (kernel, cfg)
            assert tspace.smem_bytes(kernel, shape, cfg) <= tspace.SMEM_BUDGET_BYTES
            assert tspace.threads(kernel, shape, cfg) <= tspace.MAX_THREADS

    @pytest.mark.parametrize("kernel", tspace.KERNELS)
    def test_default_config_is_candidate(self, kernel):
        shape = SHAPES[kernel]
        assert tspace.default_config(kernel, shape) in tspace.candidates(kernel, shape)

    def test_kernel_names_are_the_references(self):
        assert tspace.KERNELS == ref_tune.KERNELS

    @pytest.mark.parametrize("kernel", tspace.TILE_KERNELS)
    def test_a_tile_kernel_has_one_config_its_c_entrys(self, kernel):
        shape = SHAPES[kernel]
        assert tspace.candidates(kernel, shape) == [tspace.TILES[kernel]]
        other = dict(tspace.TILES[kernel], threads=64)
        assert not tspace.is_legal(kernel, shape, other)

    def test_shared_memory_budget_is_the_h100s(self):
        assert tspace.SMEM_BUDGET_BYTES == 227 * 1024
        # a config past the budget is illegal even when its keys are right
        big = {"bm": 128, "bn": 128, "xk": 128, "stages": 3, "threads": 256}
        assert tspace.smem_bytes("xcorr_offdiag", (256, 2048), big) > tspace.SMEM_BUDGET_BYTES
        assert not tspace.is_legal("xcorr_offdiag", (256, 2048), big)

    def test_page_candidates_are_the_references_ladder(self):
        """The reference's ladder; the reference drops the pages its VMEM
        budget cannot hold (512 at hd 256), Hopper keeps them."""
        for shape in POOLS + ((4, 9, 1, 64), (2, 3, 1, 64)):
            cap = -(-shape[1] // 8) * 8
            ladder = [{"page": p} for p in sorted({min(t, cap) for t in (8, 16, 32, 64, 128, 256, 512)})]
            mine, theirs = tspace.candidates("paged_attention", shape), ref_tune.candidates("paged_attention", shape)
            assert mine == ladder and all(c in mine for c in theirs)
            assert tspace.default_config("paged_attention", shape) == ref_tune.default_config("paged_attention", shape)
        # the Hopper kernel takes any page >= 1
        assert tspace.is_legal("paged_attention", (4, 48, 2, 16), {"page": 5})
        assert not tspace.is_legal("paged_attention", (4, 48, 2, 16), {"page": 0})

    def test_plan_candidates_prime_are_padded_and_safe(self):
        cands = tspace.candidates("sumvec_fft_plan", (101,))
        assert cands == ref_tune.candidates("sumvec_fft_plan", (101,))
        padded = [c for c in cands if c["dp"] > 101]
        assert padded
        for c in padded:
            assert c["dp"] >= 2 * 101 - 1 and c["d1"] > 1 and c["d1"] * c["d2"] == c["dp"]

    def test_grouped_block_plan_space(self):
        shape = (64, 48)
        cands = tspace.candidates("grouped_block_plan", shape)
        assert [c["b"] for c in cands] == tspace.grouped_block_size_candidates(48)
        assert tspace.default_config("grouped_block_plan", shape) == {"b": 48}
        assert tspace.default_config("grouped_block_plan", (64, 2048)) == {"b": 128}
        assert not tspace.is_legal("grouped_block_plan", shape, {"b": 1})
        assert not tspace.is_legal("grouped_block_plan", shape, {"b": 96})

    def test_auto_block_size(self):
        from repro_torch.kernels.grouped_sumvec.ops import auto_block_size

        assert (auto_block_size(2048), auto_block_size(100), auto_block_size(192), auto_block_size(8)) == (128, 100,
                                                                                                           128, 8)


# ---------------------------------------------------------------------------
# Persistent cache
# ---------------------------------------------------------------------------


class TestCache:
    def test_round_trip(self, tmp_path):
        cfg = dict(tspace.TILES["xcorr_offdiag"])
        assert tcache.store("xcorr_offdiag", (64, 256), "float32", "torch-cpu", cfg, source="dry",
                            cost={"flops": 1.0}, directory=tmp_path)
        entry = tcache.lookup("xcorr_offdiag", (64, 256), "float32", "torch-cpu", directory=tmp_path)
        assert entry["config"] == cfg and entry["source"] == "dry"
        assert tcache.lookup("xcorr_offdiag", (64, 256), "float32", "torch-cuda-sm90", directory=tmp_path) is None
        assert tcache.lookup("xcorr_offdiag", (64, 512), "float32", "torch-cpu", directory=tmp_path) is None

    def test_schema_version_invalidates(self, tmp_path):
        tcache.store("xcorr_offdiag", (64, 256), "float32", "torch-cpu", {"bm": 128}, directory=tmp_path)
        path = tmp_path / "torch-cpu.json"
        data = json.loads(path.read_text())
        data["schema"] = tcache.SCHEMA_VERSION + 1
        path.write_text(json.dumps(data))
        assert tcache.lookup("xcorr_offdiag", (64, 256), "float32", "torch-cpu", directory=tmp_path) is None

    def test_corrupt_file_is_a_miss(self, tmp_path):
        (tmp_path / "torch-cpu.json").write_text("{not json")
        assert tcache.lookup("x", (1,), "float32", "torch-cpu", directory=tmp_path) is None
        assert tcache.store("x", (8, 128), "float32", "torch-cpu", {"tn": 8}, directory=tmp_path)

    def test_concurrent_stores_keep_all_entries(self, tmp_path):
        def work(i):
            tcache.store("pmatmul", (8 * i, 128, 128), "float32", "torch-cpu", {"bm": 16}, directory=tmp_path)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(1, 9)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(tcache.load_all("torch-cpu", directory=tmp_path)) == 8

    def test_backend_keys_never_collide_with_the_references(self, tmp_path, monkeypatch):
        assert tcache.backend_key("cpu") == "torch-cpu"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert tcache.backend_key() == "torch-cpu"
        monkeypatch.setattr(torch.cuda, "get_device_capability", lambda dev=None: (9, 0))
        assert tcache.backend_key("cuda:0") == "torch-cuda-sm90"
        assert tcache.cache_dir() == tcache.Path(str(tmp_path / "cache"))

    def test_the_cache_file_is_named_torch_cpu(self, tmp_path):
        tune.tune("sumvec_fft_plan", (48,), mode="analytic")
        assert sorted(p.name for p in (tmp_path / "cache").glob("*.json")) == ["torch-cpu.json"]


# ---------------------------------------------------------------------------
# Dispatch precedence + memo
# ---------------------------------------------------------------------------


class TestDispatch:
    def test_memo_hit_skips_search(self, monkeypatch):
        calls = {"n": 0}
        real = tdispatch._analytic_search

        def counting(kernel, shape):
            calls["n"] += 1
            return real(kernel, shape)

        monkeypatch.setattr(tdispatch, "_analytic_search", counting)
        a = tune.best_config("paged_attention", (8, 48, 2, 16))
        b = tune.best_config("paged_attention", (8, 48, 2, 16))
        assert a == b and calls["n"] == 1
        tune.best_config("paged_attention", (8, 56, 2, 16))  # keys are exact shapes
        assert calls["n"] == 2

    def test_disk_cache_consulted(self):
        tcache.store("paged_attention", (8, 48, 2, 16), "float32", "torch-cpu", {"page": 8}, source="measure")
        assert tune.best_config("paged_attention", (8, 48, 2, 16)) == {"page": 8}

    def test_override_beats_cache(self):
        tcache.store("paged_attention", (8, 48, 2, 16), "float32", "torch-cpu", {"page": 8}, source="measure")
        with tune.override("paged_attention", page=24):
            assert tune.best_config("paged_attention", (8, 48, 2, 16)) == {"page": 24}
        assert tune.best_config("paged_attention", (8, 48, 2, 16)) == {"page": 8}

    def test_illegal_cached_entry_falls_back(self):
        tcache.store("xcorr_offdiag", (16, 384), "float32", "torch-cpu", {"bm": 64, "bn": 64, "xk": 32, "stages": 3,
                                                                          "threads": 256})
        assert tune.best_config("xcorr_offdiag", (16, 384)) == tspace.TILES["xcorr_offdiag"]
        tcache.store("paged_attention", (8, 48, 2, 16), "float32", "torch-cpu", {"page": 0})
        assert tune.best_config("paged_attention", (8, 48, 2, 16)) == {"page": 48}

    def test_cached_entry_with_wrong_keys_is_a_miss(self):
        tcache.store("sumvec_fft_plan", (24,), "float32", "torch-cpu", {"tm": 128})
        cfg = tune.best_config("sumvec_fft_plan", (24,))
        assert tspace.is_legal("sumvec_fft_plan", (24,), cfg)

    def test_best_impl_is_the_ports_route_rule(self):
        assert tune.best_impl("r_sum", "cuda") == "kernel" and tune.best_impl("r_sum", "cpu") == "plain"
        with tune.override("r_sum", impl="kernel"):
            assert tune.best_impl("r_sum", "cpu") == "kernel"
        with tune.override("r_sum", impl="Kernel"):
            with pytest.raises(ValueError):
                tune.best_impl("r_sum", "cpu")

    def test_call_sites_follow_best_impl(self, monkeypatch):
        """The regularizers route through ``best_impl``: an override sends a
        CPU tensor down the kernel pipeline (its plain versions here)."""
        z1, z2 = (torch.randn(8, 32, generator=torch.Generator().manual_seed(i)) for i in range(2))
        calls = []
        real = fops.r_sum_fourstep
        monkeypatch.setattr(fops, "r_sum_fourstep", lambda *a, **k: calls.append(1) or real(*a, **k))
        plain = regs.r_sum(z1, z2, scale=8.0)
        assert calls == []
        with tune.override("r_sum", impl="kernel"):
            kern = regs.r_sum(z1, z2, scale=8.0)
        assert calls == [1]
        torch.testing.assert_close(kern, plain, rtol=1e-4, atol=1e-4)

    def test_partial_plan_override_is_completed(self):
        with tune.override("sumvec_fft_plan", dp=48):
            plan = fops.fft_plan(24)
        assert (plan.dp, plan.d1, plan.d2) == (48, 6, 8)
        with tune.override("sumvec_fft_plan", d1=4, d2=6):
            assert fops.fft_plan(24).dp == 24
        with tune.override("sumvec_fft_plan", d1=16):
            plan = fops.fft_plan(2048)
        assert (plan.dp, plan.d1, plan.d2) == (2048, 16, 128)
        with tune.override("sumvec_fft_plan", dp=48, d1=4):
            plan = fops.fft_plan(24)
        assert (plan.dp, plan.d1, plan.d2) == (48, 4, 12)

    def test_unsatisfiable_plan_override_raises_valueerror(self):
        for kw in (dict(d1=5), dict(dp=30), dict(dp=48, d1=4, d2=6)):
            with tune.override("sumvec_fft_plan", **kw):
                with pytest.raises(ValueError):
                    fops.fft_plan(24)

    def test_a_plan_override_keeps_the_loss(self):
        """Any legal plan computes the same R_sum (the reference's padded and
        exact plans agree)."""
        z1, z2 = (torch.randn(8, 24, generator=torch.Generator().manual_seed(i)) for i in range(2, 4))
        want = regs.r_sum(z1, z2, q=1, scale=8.0, impl="kernel")
        for cfg in ({"dp": 48, "d1": 6, "d2": 8}, {"dp": 24, "d1": 2, "d2": 12}):
            with tune.override("sumvec_fft_plan", **cfg):
                torch.testing.assert_close(regs.r_sum(z1, z2, q=1, scale=8.0, impl="kernel"), want,
                                           rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------


class TestTuner:
    def test_dry_mode_guards_default(self):
        res = tune.tune("paged_attention", (4, 32, 2, 16), mode="dry", max_candidates=3, persist=False)
        default, best = res.candidate_for(res.default), res.candidate_for(res.best)
        assert best.cost["flops"] <= default.cost["flops"] and best.cost["hbm_bytes"] <= default.cost["hbm_bytes"]
        assert all(c.cost["flops"] > 0 for c in res.candidates)  # counted, not modelled
        # the dry tier's FLOPs and bytes are the op-level analyzer's (the
        # plain route here), the analytic launches and shared memory beside them
        for c in res.candidates:
            fn, args = ttuner._build("paged_attention", res.shape, c.config, "cpu")
            counted = tcost.compiled_cost(fn, *args)
            assert {k: c.cost[k] for k in ("flops", "hbm_bytes")} == counted
            assert c.cost["launches"] == tcost.analytic_cost("paged_attention", res.shape, c.config)["launches"]

    def test_dry_mode_deterministic_and_persists(self):
        r1 = tune.tune("sumvec_fft_plan", (48,), mode="dry", max_candidates=4)
        tdispatch.clear_memory_cache()
        r2 = tune.tune("sumvec_fft_plan", (48,), mode="dry", max_candidates=4, persist=False)
        assert r1.best == r2.best and not r2.cached
        entry = tcache.lookup("sumvec_fft_plan", r1.shape, "float32", "torch-cpu")
        assert entry is not None and entry["config"] == r1.best and entry["source"] == "dry"
        tdispatch.clear_memory_cache()
        assert tune.best_config("sumvec_fft_plan", (48,)) == r1.best

    def test_measure_mode_times_each_candidate_once(self, monkeypatch):
        calls = []
        real = tcost.measured_time_us
        monkeypatch.setattr(tcost, "measured_time_us", lambda *a, **k: calls.append(1) or real(*a, **k))
        res = tune.tune("grouped_block_plan", (16, 16), mode="measure", persist=False, max_candidates=2,
                        repeats=1, device="cpu")
        assert len(calls) == len(res.candidates) == 3  # the top 2 and the default
        assert all(c.time_us is not None and c.time_us > 0 for c in res.candidates)
        t = res.candidate_for(res.best).time_us
        assert t <= res.candidate_for(res.default).time_us  # guard_default

    def test_measure_times_a_tile_kernel_once_and_keeps_its_tile(self):
        res = tune.tune("pmatmul", (16, 16, 16), mode="measure", persist=False, repeats=1, device="cpu")
        assert res.best == res.default == tspace.TILES["pmatmul"]
        assert len(res.candidates) == 1 and res.candidates[0].time_us > 0

    def test_measure_needs_a_card_unless_the_cpu_is_asked(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tune.tune("pmatmul", (16, 16, 16), mode="measure", persist=False)

    def test_analytic_mode(self):
        res = tune.tune("paged_attention", (8, 48, 2, 16), mode="analytic", persist=False)
        assert res.best in [c.config for c in res.candidates] and res.best == {"page": 48}

    def test_a_second_tune_evaluates_nothing(self, monkeypatch):
        """A persisted entry of the same tier (or a higher one) answers the
        next tune: nothing is timed or counted again."""
        first = tune.tune("sumvec_fft_plan", (64,), mode="measure", max_candidates=2, repeats=1, device="cpu")
        monkeypatch.setattr(tcost, "measured_time_us", lambda *a, **k: pytest.fail("timed again"))
        monkeypatch.setattr(ttuner, "_dry_cost", lambda *a, **k: pytest.fail("counted again"))
        for mode in ("measure", "dry"):
            again = tune.tune("sumvec_fft_plan", (64,), mode=mode, repeats=1, device="cpu")
            assert again.cached and again.best == first.best and again.mode == "measure"
        tdispatch.clear_memory_cache()
        assert tune.best_config("sumvec_fft_plan", (64,)) == first.best

    def test_tuned_and_default_plans_give_the_same_loss_and_gradient(self):
        z1, z2 = (torch.randn(32, 64, generator=torch.Generator().manual_seed(i), requires_grad=True)
                  for i in range(4, 6))
        res = tune.tune("sumvec_fft_plan", (64,), mode="measure", max_candidates=6, repeats=1, device="cpu",
                        guard_default=False, persist=False)

        def loss_and_grad(cfg):
            with tune.override("sumvec_fft_plan", **cfg):
                loss = regs.r_sum(z1, z2, q=2, scale=32.0, impl="kernel")
            return loss, torch.autograd.grad(loss, (z1,))[0]

        for cand in res.candidates:
            (a, ga), (b, gb) = loss_and_grad(cand.config), loss_and_grad(res.default)
            torch.testing.assert_close(a, b, rtol=5e-4, atol=1e-5)
            torch.testing.assert_close(ga, gb, rtol=5e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The CLI and the job list
# ---------------------------------------------------------------------------


class TestCLI:
    def test_analytic_pretune_writes_cache(self, tmp_path, capsys):
        from repro_torch.tune import cli

        assert cli.main(["--analytic", "--shape", "8x32", "--cache-dir", str(tmp_path / "c")]) == 0
        entries = tcache.load_all("torch-cpu", directory=tmp_path / "c")
        assert any(k.startswith("sumvec_fft_plan|") for k in entries)
        assert any(k.startswith("xcorr_offdiag|") for k in entries)
        out = capsys.readouterr().out
        assert "kept default" in out and "tuned" in out

    def test_measure_on_the_cpu_and_the_serve_ladder(self, tmp_path, capsys):
        from repro_torch.tune import cli

        assert cli.main(["--measure", "--device", "cpu", "--shape", "16x32", "--block-size", "8", "--max-candidates",
                         "2", "--no-persist"]) == 0
        assert cli.main(["--analytic", "--serve", "--shape", "16x32", "--no-persist"]) == 0
        out = capsys.readouterr().out
        assert "in measure mode -> (not persisted)" in out and "in analytic mode" in out
        with pytest.raises(SystemExit):
            cli.main(["--analytic"])  # nothing to tune

    def test_serve_cli_pretunes_the_bucket_ladder(self, capsys, monkeypatch):
        """``--pretune`` warms the probe's forward shapes of every bucket
        (8, 16, 32 at the smoke's max_batch) before serving."""
        from repro_torch.serve import cli

        searches = []
        assert cli.main(["--smoke", "--requests", "32", "--pretune", "analytic", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "[serve] pre-tuned 30 forward bucket shapes (analytic)" in out and "healthy=True" in out
        monkeypatch.setattr(tdispatch, "_analytic_search", lambda *a: searches.append(a))
        assert tune.best_config("sumvec_fft_plan", (256,)) and searches == []

    def test_jobs_for_searches_b_when_unpinned(self):
        plans, jobs = jobs_for(16, 16, mode="analytic", persist=False)
        assert [p.kernel for p in plans] == ["sumvec_fft_plan", "grouped_block_plan"]
        b = plans[-1].best["b"]
        assert b in tspace.grouped_block_size_candidates(16)
        nb, nf = -(-16 // b), b // 2 + 1
        assert ("pmatmul", (16 * nb, b, 2 * nf)) in jobs
        plans_pinned, _ = jobs_for(16, 16, block_size=8, mode="analytic", persist=False)
        assert [p.kernel for p in plans_pinned] == ["sumvec_fft_plan"]


# ---------------------------------------------------------------------------
# Parity with the reference's picks and job lists
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", PLAN_DS)
def test_plan_picks_equal_the_references(d):
    mine = tune.best_config("sumvec_fft_plan", (d,))
    theirs = ref_tune.best_config("sumvec_fft_plan", (d,))
    assert mine == theirs and (mine["dp"], mine["d1"], mine["d2"]) == PLAN_PICKS[d]
    assert tune.tune("sumvec_fft_plan", (d,), mode="analytic", persist=False).best == mine


def test_grouped_plan_picks_are_the_ports_own():
    """Charged the kernels' 4-float chunks instead of TPU lanes, the port
    picks larger groups than the reference (16 / 64 / 32 there)."""
    picks = {s: tune.best_config("grouped_block_plan", s)["b"] for s in ((256, 2048), (256, 8192), (64, 2304))}
    assert picks == {(256, 2048): 64, (256, 8192): 128, (64, 2304): 64}


@pytest.mark.parametrize("n,d", [(256, 2048), (256, 8192), (64, 2304), (256, 2039), (128, 5120)])
def test_jobs_for_pinned_b_equals_the_references(n, d):
    _, mine = jobs_for(n, d, block_size=128, mode="analytic", persist=False)
    _, theirs = ref_jobs_for(n, d, block_size=128, mode="analytic", persist=False)
    assert [(k, tuple(s)) for k, s in mine] == [(k, tuple(s)) for k, s in theirs]


def test_jobs_for_keeps_the_shapes_tpu_padding_merges():
    """At a tiny width the reference's lane padding folds distinct shapes
    into one key; the port's keys are the exact shapes, so it keeps them."""
    _, mine = jobs_for(8, 32, block_size=128, mode="analytic", persist=False)
    _, theirs = ref_jobs_for(8, 32, block_size=128, mode="analytic", persist=False)
    mine, theirs = [(k, tuple(s)) for k, s in mine], [(k, tuple(s)) for k, s in theirs]
    assert set(theirs) < set(mine) and len(mine) == len(set(mine))


def test_auto_page_size_equals_the_references():
    for shape in POOLS:
        assert auto_page_size(*shape) == ref_auto_page_size(*shape) == 32
    assert PAGE_PREFER == 32
    # tests/test_paging.py's case: capped, and an override wins
    assert auto_page_size(8, 48, 2, 16) <= 32
    with tune.override("paged_attention", page=8), ref_tune.override("paged_attention", page=8):
        assert auto_page_size(8, 48, 2, 16) == ref_auto_page_size(8, 48, 2, 16) == 8


def test_engine_takes_auto_page_size_when_no_page_is_named():
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ContinuousLMEngine

    cfg = get_config("gemma2-2b").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    eng = ContinuousLMEngine(cfg, params, n_slots=4, max_len=48, max_prompt_len=24, paged=True, device="cpu")
    assert eng.pager.page == auto_page_size(4, 48, cfg.n_kv_heads, cfg.hd) == 32
    with tune.override("paged_attention", page=8):
        eng = ContinuousLMEngine(cfg, params, n_slots=4, max_len=48, max_prompt_len=24, paged=True, device="cpu")
    assert eng.pager.page == 8


@pytest.mark.parametrize("mode,dp,mp", [("local", 1, 1), ("global", 4, 1), ("tp", 2, 2), ("tp", 1, 4)])
def test_warmup_shapes_equal_the_references(mode, dp, mp):
    cfg, ref_cfg = DecorrConfig(distributed=mode, block_size=128), RefDecorrConfig(distributed=mode, block_size=128)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(dp, mp))
    assert mesh_parallelism(mesh) == (dp, mp) and mesh_parallelism(None) == (1, 1)
    assert shard_local_shape(256, 2048, cfg, data_parallel=dp, model_parallel=mp) == \
        ((256 // dp // (mp if mode == "tp" else 1)), 2048)
    mine = warmup_tune_cache(256, 2048, cfg, mesh=mesh, mode="analytic")
    theirs = ref_warmup(256, 2048, ref_cfg, data_parallel=dp, model_parallel=mp, mode="analytic")
    rows = 256 // dp // (mp if mode == "tp" else 1)
    plans, jobs = ref_jobs_for(rows, 2048, block_size=128, mode="analytic", persist=False)
    # the reference's results carry TPU-padded shapes; its job list, exact ones
    assert [(r.kernel, r.shape) for r in mine] == [(p.kernel, p.shape) for p in plans] + [(k, tuple(s)) for k, s in jobs]
    assert [r.kernel for r in mine] == [r.kernel for r in theirs]
    assert all(r.best == r.default for r in mine if r.kernel in tspace.TILE_KERNELS)
