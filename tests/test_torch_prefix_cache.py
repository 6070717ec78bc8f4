"""The port's prefix radix cache against the reference.

Bottom-up, the same operations on both packages must reach the same state:
the allocator's refcounts, pins, shared-page credit, copy-on-write and
on-demand eviction; the radix tree's matches, splits, first-writer-wins
inserts and LRU tail-truncation eviction; the manager's chunk-quantized
plans, bound tables, scatter / reset rows and COW moves.  Then the device
half (the warm-template gather) on the same pools, and end to end: warm
requests resuming chunked prefill over shared pages emit the same tokens
as the unshared chunk-all engine and as the reference's warm engine, on the
reference's two-phase mix (exact on the CPU).
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
from repro.serve.paging import PageAllocator as RefAllocator  # noqa: E402
from repro.serve.paging import PagedKVManager as RefManager  # noqa: E402
from repro.serve.paging import RadixCache as RefRadix  # noqa: E402
from repro.train import serve as ref_serve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.decorr.config import DecorrConfig  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve.engine import ContinuousLMEngine  # noqa: E402
from repro_torch.serve.loadgen import SharedPrefixLoadConfig, compare_prefix_sharing, lm_probe_oracle_err  # noqa: E402
from repro_torch.serve.paging import PageAllocator, PagedKVManager, RadixCache  # noqa: E402
from repro_torch.serve.probes import DecorrProbe  # noqa: E402
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


def _alloc_state(a):
    return dict(
        tables=[a.table(s) for s in range(a.n_slots)],
        shared=[a.shared_count(s) for s in range(a.n_slots)],
        refcount=dict(a._refcount),
        pins=dict(a._pins),
        free=sorted(a._free),
        metrics=a.metrics(),
    )


def _both(pair, op, *args, **kw):
    """Run one operation on the port and the reference object; both must
    return the same value or raise the same exception type."""
    out = []
    for obj in pair:
        try:
            out.append(("ok", getattr(obj, op)(*args, **kw)))
        except (RuntimeError, AssertionError) as e:
            out.append(("raise", type(e).__name__))
    assert out[0] == out[1], (op, args, out)
    return out[0]


# ---------------------------------------------------------------------------
# the allocator's sharing accounting
# ---------------------------------------------------------------------------


def test_allocator_sharing_ops_reach_the_same_state():
    """Reservations with shared credit, bind_shared, cow_bind, refcounts,
    pins, pinned scratch, swaps, double frees, exhaustion with and without
    the eviction hook, and compaction that leaves shared / pinned pages."""
    pair = (PageAllocator(9, 8, 4, 4), RefAllocator(9, 8, 4, 4))
    ops = [
        ("reserve", 0, 24), ("ensure", 0, 24), ("retain", 2), ("pin_page", 1), ("release", 0),
        ("can_reserve", 40), ("can_reserve", 40, dict(shared_pages=2, new_pins=1)),
        ("reserve", 1, 32, dict(shared_pages=2)), ("bind_shared", 1, [2]), ("cow_bind", 1, 1),
        ("ensure", 1, 32), ("cow_bind", 1, 1), ("retain", 7), ("release_page", 5), ("release_page", 5),
        ("unpin_page", 3), ("alloc_pinned", 2), ("reserve", 2, 8), ("ensure", 2, 8),
        ("swap_page", 2, 0, 5), ("plan_compaction", 4), ("release", 2), ("plan_compaction", 4),
        ("release", 1), ("unpin_page", 1), ("release_page", 1), ("release_page", 2), ("plan_compaction", 8),
        ("reserve", 3, 32), ("ensure", 3, 32), ("reserve", 0, 8), ("ensure", 0, 8),
    ]
    for op, *args in ops:
        kw = args.pop() if args and isinstance(args[-1], dict) else {}
        _both(pair, op, *args, **kw)
        assert _alloc_state(pair[0]) == _alloc_state(pair[1]), (op, args)
    assert pair[0].shared_pages == pair[1].shared_pages and pair[0].pinned_pages == pair[1].pinned_pages


def test_allocator_evicts_through_its_hook():
    """A dry free list calls the eviction hook; without one it raises."""
    for cls in (PageAllocator, RefAllocator):
        a = cls(4, 8, 2, 4)  # 3 usable pages
        a.reserve(0, 24)
        a.ensure(0, 24)
        a.retain(1)  # a cache owner keeps page 1 alive
        a.release(0)
        a.reserve(1, 24)
        a.ensure(1, 16)
        freed = []
        a.evict_hook = lambda need, a=a: freed.append(a.release_page(1)) or 1
        a.ensure(1, 24)
        assert freed == [True] and a.table(1) == [2, 3, 1]
        a.evict_hook = None
        a.retain(2)
        a.release(1)
        a.reserve(0, 24)
        with pytest.raises(RuntimeError, match="exhausted"):
            a.ensure(0, 24)


# ---------------------------------------------------------------------------
# the radix tree
# ---------------------------------------------------------------------------


def _radix_state(r):
    out, stack = [], [((), r.root)]
    while stack:
        path, nd = stack.pop()
        out.append((path, tuple(nd.key), tuple(nd.pages)))
        for k in sorted(nd.children):
            stack.append((path + (k,), nd.children[k]))
    return sorted(out), r.metrics()


def test_radix_matches_inserts_splits_and_evicts_like_the_reference():
    """Random prompts over two shared prefixes (page 4): the same matches
    (full pages, token count, partial page), the same tree after every
    insert (splits only at page boundaries, first writer wins) and the same
    LRU evictions, pinned pages skipped."""
    rng = np.random.default_rng(0)
    allocs = (PageAllocator(64, 4, 1, 16), RefAllocator(64, 4, 1, 16))
    radixes = (RadixCache(4, allocs[0]), RefRadix(4, allocs[1]))
    prefixes = [rng.integers(0, 5, 11).tolist(), rng.integers(0, 5, 6).tolist()]
    next_page = [1]

    def pages(n):
        out = list(range(next_page[0], next_page[0] + n))
        next_page[0] += n
        for a in allocs:
            for p in out:
                a._refcount[p] = 1  # a donor slot owns each page
                a._free.remove(p)
                a.in_use += 1
        return out

    for step in range(40):
        p = prefixes[step % 2][: int(rng.integers(2, 12))]
        toks = p + rng.integers(0, 5, int(rng.integers(0, 9))).tolist()
        matches = [r.match(toks) for r in radixes]
        assert [(m.pages, m.tokens, m.partial) for m in matches] == [(m.pages, m.tokens, m.partial) for m in matches[::-1]]
        full = len(toks) // 4
        if full and step % 3 != 2:
            donated = pages(full)
            assert radixes[0].insert(toks[: full * 4], donated) == radixes[1].insert(toks[: full * 4], donated)
        if step % 7 == 6:
            victim = matches[0].pages[:1]
            for a in allocs:
                for v in victim:
                    a.pin_page(v)
            assert radixes[0].evict(3) == radixes[1].evict(3)
            for a in allocs:
                for v in victim:
                    a.unpin_page(v)
        assert _radix_state(radixes[0]) == _radix_state(radixes[1]), step
        assert _alloc_state(allocs[0]) == _alloc_state(allocs[1]), step
    assert radixes[0].splits_total > 0 and radixes[0].evicted_pages_total > 0


# ---------------------------------------------------------------------------
# the manager's plans
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gemma():
    rcfg = ref_config("gemma2-2b").reduced()
    cfg = get_config("gemma2-2b").reduced()
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    return cfg, params, rcfg, rparams


def _plan_tuple(p):
    return p.hit, list(p.shared), p.cow_src, p.matched_tokens


@pytest.mark.parametrize("page,chunk,total", [(8, 4, None), (8, 8, 7), (4, 4, 13)])
def test_manager_plans_and_tables_match_the_reference(gemma, page, chunk, total):
    """Cold admission and donation, then warm plans (quantized to the chunk
    grid, capped at prompt_len - 1; mid-page hits copy the boundary page),
    bound tables, scatter / reset rows, COW moves, pins and metrics."""
    cfg, _, rcfg, _ = gemma
    mgrs = (PagedKVManager(cfg, 4, 48, page, total_pages=total, prefix_cache=True, prefix_chunk=chunk),
            RefManager(rcfg, 4, 48, page, total_pages=total, prefix_cache=True, prefix_chunk=chunk))
    toks = np.arange(24, dtype=np.int32)
    warm = [toks, np.concatenate([toks[:21], [99, 99, 99]]).astype(np.int32), np.arange(30, dtype=np.int32),
            np.concatenate([toks[:9], [7] * 6]).astype(np.int32)]
    plans = [m.plan_prefix(toks, 24) for m in mgrs]
    for m, p in zip(mgrs, plans):
        m.admit(0, 24, 4, plan=p)
        m.ensure_rows(0, 24)
    donated = [m.donate(0, toks) for m in mgrs]
    assert donated[0] == donated[1] == 24 // page
    for m in mgrs:
        m.release(0)
    for slot, t in enumerate(warm):
        n = len(t)
        plans = [m.plan_prefix(t, n) for m in mgrs]
        assert _plan_tuple(plans[0]) == _plan_tuple(plans[1])
        ok = [m.can_admit(n, 8, plan=p) for m, p in zip(mgrs, plans)]
        assert ok[0] == ok[1]
        if not ok[0]:
            continue
        hits = [m.admit(slot, n, 8, plan=p) for m, p in zip(mgrs, plans)]
        assert hits[0] == hits[1] == mgrs[0].prefix_hit(slot) == mgrs[1].prefix_hit(slot)
        for m in mgrs:
            m.ensure_rows(slot, n)
        moves = [m.cow_moves(slot) for m in mgrs]
        assert (moves[0] is None) == (moves[1] is None)
        if moves[0] is not None:
            assert (int(moves[0][0][0]), int(moves[0][1][0])) == (int(moves[1][0][0]), int(moves[1][1][0]))
        for fn in ("table_row", "scatter_row", "reset_row"):
            np.testing.assert_array_equal(getattr(mgrs[0], fn)(slot), getattr(mgrs[1], fn)(slot))
        assert mgrs[0].donate(slot, t) == mgrs[1].donate(slot, t)
        assert _alloc_state(mgrs[0].alloc) == _alloc_state(mgrs[1].alloc)
    for slot in range(len(warm)):
        for m in mgrs:
            m.release(slot)
    assert _alloc_state(mgrs[0].alloc) == _alloc_state(mgrs[1].alloc)
    assert mgrs[0].metrics() == mgrs[1].metrics()
    assert mgrs[0].prefix_hits > 0


def test_manager_requires_a_chunk(gemma):
    cfg = gemma[0]
    with pytest.raises(ValueError, match="prefix_chunk"):
        PagedKVManager(cfg, n_slots=2, max_len=32, page=8, prefix_cache=True)


def test_template_gather_matches_the_reference(gemma):
    """``load_template_from_pages``: the same random pool gathered through
    the same table row (a sentinel tail) into a batch-1 template."""
    cfg, _, rcfg, _ = gemma
    mgr = PagedKVManager(cfg, 2, 48, 8)
    pool = mgr.init_caches("cpu")
    rng = np.random.default_rng(4)
    for leafs in pool.values():
        for t in leafs.values():
            t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)))
    rpool = {n: {k: jnp.asarray(v.numpy()) for k, v in leafs.items()} for n, leafs in pool.items()}
    row = np.asarray([3, 7, 1, 0, 0, 0], np.int32)
    from repro_torch.models.transformer import init_caches

    got = serve.load_template_from_pages(pool, init_caches(cfg, 1, 48, "cpu"), row)
    want = ref_serve.load_template_from_pages(rpool, ref_serve.init_caches(rcfg, 1, 48), jnp.asarray(row))
    for name in got:
        for key in ("k", "v"):
            np.testing.assert_array_equal(got[name][key].numpy(), np.asarray(want[name][key]))


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

# the reference's two-phase mix (tests/test_prefix_cache.py): page 8, chunk 4
# and a 21-token prefix, so a cold tail extends the donated pages past the
# prefix and warm hits land mid-page (copy-on-write)
E2E = dict(n_slots=4, max_len=48, max_prompt_len=26, paged=True, page_size=8, prefill_chunk=4, chunk_all=True)
TAILS = [(3, 4), (2, 6), (5, 3), (4, 5)]  # (tail_len, max_new); [0] is cold


def _prefix_spec(cfg, prefix_len=21, tails=TAILS, seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, prefix_len).astype(np.int32)
    return [(np.concatenate([prefix, rng.integers(0, cfg.vocab_size, t).astype(np.int32)]), m) for t, m in tails]


def _two_phase(engine_cls, service_cls, cfg, params, spec, *, n_cold=1, probe=None, record=False,
               submit_kw=None, **engine_kw):
    eng = engine_cls(cfg, params, **dict(E2E, **engine_kw))
    svc = service_cls(eng, probe=probe, record_probe_rows=record)
    svc.warmup()
    futs = []
    for i, (t, m) in enumerate(spec):
        futs.append(svc.submit(t, m, **(submit_kw(i) if submit_kw else {})))
        if i < n_cold:
            svc.drain()
    svc.drain()
    return [np.asarray(f.result(timeout=60)) for f in futs], svc


def _port(*a, **kw):
    return _two_phase(ContinuousLMEngine, LMService, *a, device="cpu", **kw)


def test_warm_tokens_equal_unshared_and_the_reference(gemma):
    """Warm == unshared chunk-all == the reference's warm run, through the
    copy-on-write boundary page; the same hit / miss / COW counts."""
    cfg, params, rcfg, rparams = gemma
    spec = _prefix_spec(cfg)
    base, _ = _port(cfg, params, spec, prefix_cache=False)
    outs, svc = _port(cfg, params, spec, prefix_cache=True)
    want, rsvc = _two_phase(RefEngine, RefService, rcfg, rparams, spec, prefix_cache=True)
    for o, b, w in zip(outs, base, want):
        np.testing.assert_array_equal(o, b)
        np.testing.assert_array_equal(o, w)
    m, rm = svc.metrics(), rsvc.metrics()
    for key in ("paged_prefix_hits_total", "paged_prefix_misses_total", "paged_prefix_cow_total",
                "paged_prefix_hit_tokens_total", "paged_pages_peak", "paged_radix_cached_pages", "paged_shared_pages"):
        assert m[key] == rm[key], key
    assert m["paged_prefix_hits_total"] == 3.0 and m["paged_prefix_cow_total"] >= 1.0
    assert m["paged_pages_reserved"] == 0.0 and m["paged_pages_in_use"] == m["paged_radix_cached_pages"] > 0


def test_tiny_pool_evicts_and_completes(gemma):
    """Two prefix families outgrow an 8-page pool: eviction under pressure,
    tokens still equal to the unshared run and the reference's."""
    cfg, params, rcfg, rparams = gemma
    spec = _prefix_spec(cfg, seed=0)[:3] + _prefix_spec(cfg, seed=7)[:3]
    spec = [spec[i] for i in (0, 3, 1, 4, 2, 5)]  # cold A, cold B, then warms
    base, _ = _port(cfg, params, spec, n_cold=2, prefix_cache=False, total_pages=9)
    outs, svc = _port(cfg, params, spec, n_cold=2, prefix_cache=True, total_pages=9)
    want, rsvc = _two_phase(RefEngine, RefService, rcfg, rparams, spec, n_cold=2, prefix_cache=True, total_pages=9)
    for o, b, w in zip(outs, base, want):
        np.testing.assert_array_equal(o, b)
        np.testing.assert_array_equal(o, w)
    m = svc.metrics()
    assert m["paged_radix_evicted_pages_total"] == rsvc.metrics()["paged_radix_evicted_pages_total"] > 0
    assert m["paged_pages_peak"] <= 8.0 and m["paged_pages_reserved"] == 0.0


def test_sampling_rides_the_prefix_cache(gemma):
    """Seeded sampled requests: warm == unshared, and == the reference."""
    cfg, params, rcfg, rparams = gemma
    spec = _prefix_spec(cfg)
    kw = lambda i: dict(temperature=0.8, top_k=8, seed=100 + i)  # noqa: E731
    warm, _ = _port(cfg, params, spec, prefix_cache=True, sampling=True, submit_kw=kw)
    base, _ = _port(cfg, params, spec, prefix_cache=False, sampling=True, submit_kw=kw)
    want, _ = _two_phase(RefEngine, RefService, rcfg, rparams, spec, prefix_cache=True, sampling=True, submit_kw=kw)
    for a, b, w in zip(warm, base, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, w)


def test_probe_matches_its_oracle_under_sharing(gemma):
    cfg, params, _, _ = gemma
    probe = DecorrProbe(DecorrConfig(style="vic", reg="sum", q=2), device="cpu")
    _, svc = _port(cfg, params, _prefix_spec(cfg), prefix_cache=True, probe=probe, record=True)
    assert probe.steps >= 1
    err = lm_probe_oracle_err(svc)
    assert err is not None and err < 1e-3


def test_gating_errors(gemma):
    cfg, params, _, _ = gemma
    with pytest.raises(ValueError, match="paged"):
        ContinuousLMEngine(cfg, params, n_slots=2, max_len=32, prefix_cache=True, device="cpu")
    eng = ContinuousLMEngine(cfg, params, n_slots=2, max_len=32, paged=True, page_size=8, prefix_cache=True,
                             device="cpu")
    # prefix caching forces chunk_all, on the page grid when no chunk is named
    assert eng.chunk_all and eng.prefill_chunk == 8 and eng.pager.prefix_chunk == 8


def test_compare_prefix_sharing_on_the_reference_workload(gemma):
    """``loadgen.compare_prefix_sharing`` on ``SharedPrefixLoadConfig()``
    (2 prefixes of 92 tokens, fan-out 7) at the reference CLI's shape (4
    slots, page 16, chunk 8): identical tokens, fewer peak pages, hits and
    at least one copy-on-write."""
    cfg, params, _, _ = gemma
    rep = compare_prefix_sharing(cfg, params, SharedPrefixLoadConfig(), n_slots=4, page_size=16, prefill_chunk=8,
                                 device="cpu")
    g = rep["gate"]
    assert g["token_mismatches"] == 0 and g["peak_pages_lt_unshared"]
    assert g["prefix_hit_rate"] > 0 and g["prefix_cow_total"] >= 1
