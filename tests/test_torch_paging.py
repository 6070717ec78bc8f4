"""The port's paged-KV bookkeeping against the reference: the reference's
``TestPageAllocator`` cases replayed on the port's ``PageAllocator``, the
block tables of both ``PagedKVManager``s after the same admit / ensure /
release / compaction sequence, the byte accounting, and the device half
(slot insert / reset and page moves) on the same random pools."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.serve.paging import PageAllocator as RefAllocator  # noqa: E402
from repro.serve.paging import PagedKVManager as RefManager  # noqa: E402
from repro.serve.paging import attn_kv_bytes_per_row as ref_bytes_per_row  # noqa: E402
from repro.train import serve as ref_serve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serve.paging import PageAllocator, PagedKVManager, attn_kv_bytes_per_row, dense_cache_bytes  # noqa: E402
from repro_torch.train import serve  # noqa: E402


def _alloc(total=9, page=8, n_slots=4, nb=4):
    return PageAllocator(total, page, n_slots, nb)


# ---------------------------------------------------------------------------
# the reference's TestPageAllocator cases, on the port
# ---------------------------------------------------------------------------


def test_alloc_prefers_low_ids_and_never_sentinel():
    a = _alloc()
    a.reserve(0, 24)
    added = a.ensure(0, 24)
    assert [phys for _, phys in added] == [1, 2, 3]
    assert a.table(0) == [1, 2, 3]
    assert a.in_use == 3 and a.peak_pages == 3


def test_free_pages_return_and_are_reused():
    a = _alloc()
    a.reserve(0, 16)
    a.ensure(0, 16)
    a.reserve(1, 8)
    a.ensure(1, 8)
    assert a.table(1) == [3]
    a.release(0)
    assert a.free_pages() == a.usable_pages - 1
    a.reserve(2, 8)
    a.ensure(2, 8)
    assert a.table(2) == [1]


def test_reservation_accounting_oom_safe():
    a = _alloc(total=5)
    assert a.can_reserve(32)
    a.reserve(0, 24)
    assert not a.can_reserve(16)
    assert a.can_reserve(8)
    with pytest.raises(RuntimeError, match="reservation overflow"):
        a.reserve(1, 16)
    a.ensure(0, 24)
    with pytest.raises(RuntimeError, match="> reservation"):
        a.ensure(0, 25)
    a.release(0)
    assert a.reserved_total == 0 and a.in_use == 0


def test_fits_ever_bounds_by_pool_and_slot_blocks():
    a = _alloc(total=5, nb=2)
    assert a.fits_ever(16)
    assert not a.fits_ever(17)


def test_compaction_relocates_high_pages_into_low_holes():
    a = _alloc(total=9)
    a.reserve(0, 16)
    a.ensure(0, 16)
    a.reserve(1, 16)
    a.ensure(1, 16)
    a.release(0)
    moves = a.plan_compaction(max_moves=4)
    assert moves == [(4, 1), (3, 2)]
    assert a.table(1) == [2, 1]
    assert a.frontier() == 3
    assert a.plan_compaction(max_moves=4) == []


def test_metrics_shape():
    m = _alloc().metrics()
    for k in ("pages_total", "pages_in_use", "pages_peak", "pages_reserved"):
        assert k in m


# ---------------------------------------------------------------------------
# the port's bookkeeping step for step against the reference's
# ---------------------------------------------------------------------------


def _replay(alloc_a, alloc_b, seed, steps=300, n_slots=4, page=8):
    """Random reserve / ensure / release / compaction sequence on two
    allocators; every table, counter and move must agree after each step."""
    rng = np.random.default_rng(seed)
    rows = [0] * n_slots
    live = [False] * n_slots
    for _ in range(steps):
        s = int(rng.integers(n_slots))
        op = rng.integers(3)
        if not live[s]:
            need = int(rng.integers(1, 33))
            fits = alloc_a.can_reserve(need)
            assert fits == alloc_b.can_reserve(need)
            if fits:
                alloc_a.reserve(s, need)
                alloc_b.reserve(s, need)
                live[s], rows[s] = need, 0
        elif op == 0 and rows[s] < live[s]:
            rows[s] = int(rng.integers(rows[s] + 1, live[s] + 1))
            assert alloc_a.ensure(s, rows[s]) == alloc_b.ensure(s, rows[s])
        elif op == 1:
            alloc_a.release(s)
            alloc_b.release(s)
            live[s] = False
            assert alloc_a.plan_compaction(4) == alloc_b.plan_compaction(4)
        for k in range(n_slots):
            assert alloc_a.table(k) == alloc_b.table(k)
        assert (alloc_a.in_use, alloc_a.reserved_total, alloc_a.peak_pages, alloc_a.frontier()) == (
            alloc_b.in_use, alloc_b.reserved_total, alloc_b.peak_pages, alloc_b.frontier())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_replays_the_reference(seed):
    _replay(PageAllocator(14, 8, 4, 4), RefAllocator(14, 8, 4, 4), seed)


def test_manager_block_tables_equal_the_reference():
    rcfg = ref_config("gemma2-2b").reduced()
    cfg = get_config("gemma2-2b").reduced()
    mine = PagedKVManager(cfg, n_slots=3, max_len=32, page=8, total_pages=9)
    ref = RefManager(rcfg, n_slots=3, max_len=32, page=8, total_pages=9)
    seq = [("admit", 0, 9, 4), ("ensure", 0, 9), ("admit", 1, 17, 6), ("ensure", 1, 17), ("ensure", 0, 12),
           ("admit", 2, 3, 2), ("ensure", 2, 3), ("ensure", 1, 22), ("release", 0), ("compact",),
           ("admit", 0, 5, 3), ("ensure", 0, 5), ("release", 1), ("compact",), ("ensure", 0, 7)]
    for op, *args in seq:
        if op == "admit":
            assert mine.can_admit(*args[1:]) == ref.can_admit(*args[1:])
            mine.admit(*args)
            ref.admit(*args)
        elif op == "ensure":
            assert mine.ensure_rows(*args) == ref.ensure_rows(*args)
        elif op == "release":
            mine.release(*args)
            ref.release(*args)
        else:
            src, dst = mine.plan_compaction()
            rsrc, rdst = ref.plan_compaction()
            keep = rsrc != rdst  # the reference pads with identity moves
            np.testing.assert_array_equal(src, rsrc[keep])
            np.testing.assert_array_equal(dst, rdst[keep])
        np.testing.assert_array_equal(mine.block_tables(), ref.block_tables())
    for k in ("paged_pages_in_use", "paged_pages_peak", "paged_peak_cache_bytes", "paged_pool_cache_bytes",
              "paged_dense_equiv_bytes", "paged_pages_compaction_moves"):
        assert mine.metrics()[k] == ref.metrics()[k], k


def test_byte_accounting_matches_the_reference():
    for dtype, rdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        import dataclasses

        cfg = dataclasses.replace(get_config("gemma2-2b"), compute_dtype=dtype)
        rcfg = dataclasses.replace(ref_config("gemma2-2b"), compute_dtype=rdtype)
        assert attn_kv_bytes_per_row(cfg) == ref_bytes_per_row(rcfg)
    # the full-width gemma2-2b row: 26 layers x (k, v) x 4 kv heads x 256
    assert attn_kv_bytes_per_row(get_config("gemma2-2b")) == 26 * 2 * 4 * 256 * 2
    assert dense_cache_bytes(get_config("gemma2-2b"), 8, 64) == 8 * 64 * 26 * 2 * 4 * 256 * 2


def test_every_reference_arch_resolves_and_an_unknown_one_raises():
    from repro.configs import list_archs as ref_list_archs
    from repro_torch.configs import list_archs

    assert list_archs() == ref_list_archs()
    for name in ref_list_archs():
        assert get_config(name).name == ref_config(name).name
    assert repr(get_config("ssl-paper")) == repr(ref_config("ssl-paper"))
    with pytest.raises(KeyError):
        get_config("no-such-arch")


# ---------------------------------------------------------------------------
# the device half: slot surgery and page moves
# ---------------------------------------------------------------------------


def _pool(rng, repeats=2, pages=7, page=4, kv=2, hd=3):
    vals = {f"pos{i}": {k: rng.standard_normal((repeats, pages, page, kv, hd)).astype(np.float32)
                        for k in ("k_pages", "v_pages")} for i in range(2)}
    port = {n: {k: torch.from_numpy(v.copy()) for k, v in leafs.items()} for n, leafs in vals.items()}
    return port, jax.tree.map(jnp.asarray, vals)


def _same(port, ref, skip_sentinel=False):
    for name, leafs in port.items():
        for key, leaf in leafs.items():
            got, want = leaf.numpy(), np.asarray(ref[name][key])
            if skip_sentinel:
                got, want = got[:, 1:], want[:, 1:]
            np.testing.assert_array_equal(got, want)


def test_apply_page_moves_reads_every_source_before_writing():
    rng = np.random.default_rng(0)
    port, ref = _pool(rng)
    before = port["pos0"]["k_pages"].clone()
    src, dst = np.asarray([1, 2, 4], np.int32), np.asarray([2, 3, 4], np.int32)  # a chain 1 -> 2 -> 3
    serve.apply_page_moves(port, src, dst)
    _same(port, ref_serve.apply_page_moves(ref, jnp.asarray(src), jnp.asarray(dst)))
    torch.testing.assert_close(port["pos0"]["k_pages"][:, 3], before[:, 2])
    torch.testing.assert_close(port["pos0"]["k_pages"][:, 2], before[:, 1])


def test_insert_and_reset_slot_state_paged_match_the_reference():
    rng = np.random.default_rng(1)
    port, ref = _pool(rng)
    one_np = {f"pos{i}": {k: rng.standard_normal((2, 1, 12, 2, 3)).astype(np.float32) for k in ("k", "v")}
              for i in range(2)}
    one_t = {n: {k: torch.from_numpy(v) for k, v in leafs.items()} for n, leafs in one_np.items()}
    row = np.asarray([5, 2, 0], np.int32)  # two owned blocks, one on the sentinel
    serve.insert_slot_state_paged(port, one_t, 1, row)
    ref = ref_serve.insert_slot_state_paged(ref, jax.tree.map(jnp.asarray, one_np), 1, jnp.asarray(row))
    _same(port, ref, skip_sentinel=True)  # the reference also writes page 0, which nothing reads
    serve.reset_slot_state_paged(port, 1, row)
    _same(port, ref_serve.reset_slot_state_paged(ref, 1, jnp.asarray(row)))


def test_moe_paged_decode_lanes_sharing_a_row_write_what_the_reference_writes():
    """Free lanes of a MoE arch all write the sentinel page's row 0 and read
    it back, and MoE capacity lets their rows take real tokens' seats: the
    row holds the last such lane's k / v, as the reference's scatter leaves
    it, and every live lane's row holds its own."""
    from repro_torch.models import attention

    # lanes 0-4 free (cache_len 0, every entry the sentinel page 0: all five
    # write row 0 of page 0), 5-7 live on pages 1-3 at cache_len 2
    cfg = get_config("llama4-scout-17b-a16e").reduced()
    kv, hd = cfg.n_kv_heads, cfg.hd
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((8, 1, h, hd)).astype(np.float32) for h in (cfg.n_heads, kv, kv))
    tables = np.zeros((8, 2), np.int32)
    tables[5:, 0] = [1, 2, 3]
    lens = np.asarray([0] * 5 + [2] * 3, np.int32)
    pages = rng.standard_normal((2, 4, 4, kv, hd)).astype(np.float32)
    cache = {"k_pages": torch.from_numpy(pages[0].copy()), "v_pages": torch.from_numpy(pages[1].copy())}
    attention._paged_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), cache,
                            torch.from_numpy(lens), torch.from_numpy(tables), cfg, cfg.pattern[0], impl="plain")
    phys, row = tables[np.arange(8), lens // 4], lens % 4
    for key, src, new in (("k_pages", 0, k), ("v_pages", 1, v)):
        want = jnp.asarray(pages[src]).at[phys, row].set(jnp.asarray(new[:, 0]))
        np.testing.assert_array_equal(cache[key].numpy(), np.asarray(want))
        np.testing.assert_array_equal(cache[key][0, 0].numpy(), new[4, 0])


# ---------------------------------------------------------------------------
# retirement (reset and compaction) against the reference engine
# ---------------------------------------------------------------------------

# (prompt, new tokens): one prompt bucket of 8 keeps the reference's compiles
# few; at page 8 over 4 slots the retirements leave holes that compaction fills
SPEC = [(4, 5), (8, 3), (6, 12), (3, 2), (1, 4), (7, 9)]
PAGE_KINDS = ("page_alloc", "page_free", "page_compact")


def _serve_mix(engine_cls, service_cls, cfg, params, spec, **engine_kw):
    """Serve the mix; (tokens, page records without seq / time, the pools)."""
    eng = engine_cls(cfg, params, n_slots=4, max_len=32, max_prompt_len=8, paged=True, page_size=8, **engine_kw)
    svc = service_cls(eng)
    svc.warmup()
    futs = [svc.submit(t, m) for t, m in spec]
    svc.drain()
    records = [{k: v for k, v in ev.items() if k not in ("seq", "t")}
               for ev in svc.obs.recorder.events() if ev["kind"] in PAGE_KINDS]
    return [np.asarray(f.result(timeout=30)) for f in futs], records, eng.caches


def _live_pages(caches):
    """The physical pages past the sentinel that hold a nonzero value in
    some paged leaf."""
    live = set()
    for leafs in caches.values():
        for key in ("k_pages", "v_pages") if "k_pages" in leafs else ():
            pages = np.asarray(leafs[key], np.float32)
            nonzero = np.any(pages.reshape(pages.shape[0], pages.shape[1], -1) != 0, axis=(0, 2))
            live |= {int(p) for p in np.nonzero(nonzero)[0] if p > 0}
    return live


def test_retirement_resets_and_compacts_as_the_reference_engine_does():
    """Reduced gemma2-2b, paged at page 8, with the reference's weights:
    the tokens, the page records (with ``page_compact`` among them) and the
    set of nonzero pages left after the drain equal the reference engine's,
    whose retirement resets and compacts by default as the port's always
    does."""
    from repro.models import init_params as ref_init
    from repro.serve.engine import ContinuousLMEngine as RefEngine
    from repro.serve.service import LMService as RefService
    from repro_torch.models import params_from_jax
    from repro_torch.serve.engine import ContinuousLMEngine
    from repro_torch.serve.service import LMService

    rcfg = ref_config("gemma2-2b").reduced()
    cfg = get_config("gemma2-2b").reduced()
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    rng = np.random.default_rng(0)
    spec = [(rng.integers(0, cfg.vocab_size, s).astype(np.int32), m) for s, m in SPEC]
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # see tests/test_torch_lm_train.py's _one_torch_thread
    try:
        outs, records, caches = _serve_mix(ContinuousLMEngine, LMService, cfg, params, spec, device="cpu")
    finally:
        torch.set_num_threads(n)
    want, want_records, want_caches = _serve_mix(RefEngine, RefService, rcfg, rparams, spec)
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o, w)
    assert records == want_records
    assert any(r["kind"] == "page_compact" for r in records)
    assert _live_pages(caches) == _live_pages(want_caches)
