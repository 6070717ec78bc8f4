"""The port's decoder LM (``repro_torch.models``) against the reference on
reduced gemma2-2b in f32, with the reference's own weights carried across
by ``params_from_jax``: score forward, prefill, dense decode with a scalar
and a per-slot ``cache_len``, and paged (block-table) decode.  Logits within
1e-4 x max(1, max |ref|), hidden states and written caches within 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.models.transformer import forward as ref_forward  # noqa: E402
from repro.models.transformer import init_caches as ref_init_caches  # noqa: E402
from repro.models.transformer import init_paged_caches as ref_init_paged  # noqa: E402
from repro.train import serve as ref_serve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import forward, init_caches, init_paged_caches, init_params, params_from_jax  # noqa: E402
from repro_torch.models.common import activation_fn  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402
from repro_torch.train import serve  # noqa: E402

HIDDEN_TOL = 1e-5


@pytest.fixture(scope="module")
def gemma():
    rcfg = ref_config("gemma2-2b").reduced()
    cfg = get_config("gemma2-2b").reduced()
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    return rcfg, cfg, rparams, params


def _logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-4 * max(1.0, float(np.abs(want).max())))


def _close(got, want, atol=HIDDEN_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _caches_close(port_caches, ref_caches):
    for name, leafs in port_caches.items():
        for key, leaf in leafs.items():
            _close(leaf.numpy(), ref_caches[name][key])


def _random_caches(rng, ref_caches):
    """The same random values in both frameworks' cache trees."""
    vals = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), ref_caches)
    port = {n: {k: torch.from_numpy(v.copy()) for k, v in leafs.items()} for n, leafs in vals.items()}
    return port, jax.tree.map(jnp.asarray, vals)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 41).astype(np.float32)
    _close(activation_fn("gelu")(torch.from_numpy(x)).numpy(), jax.nn.gelu(x), atol=1e-6)


def test_params_from_jax_checks_shapes(gemma):
    rcfg, cfg, rparams, _ = gemma
    tree = jax.tree.map(np.asarray, rparams)
    tree["final_norm"] = tree["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_jax(cfg, tree, device="cpu")


def _is_shape(x):
    return isinstance(x, tuple)


@pytest.mark.parametrize(
    "make",
    [
        lambda cfg: init_params(cfg, seed=0),
        lambda cfg: params_from_jax(cfg, jax.tree.map(np.zeros, param_shapes(cfg), is_leaf=_is_shape)),
        lambda cfg: init_caches(cfg, 1, 8),
        lambda cfg: init_paged_caches(cfg, 3, 4),
    ],
    ids=["init_params", "params_from_jax", "init_caches", "init_paged_caches"],
)
def test_constructors_run_on_cuda_unless_cpu_is_asked(make):
    """No device named means ``cuda``: without CUDA the constructor raises
    instead of building on the CPU."""
    cfg = get_config("gemma2-2b").reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(cfg)
        return
    leaves = jax.tree.leaves(make(cfg))
    assert leaves and all(t.is_cuda for t in leaves)


def test_init_params_matches_the_reference_layout(gemma):
    rcfg, cfg, rparams, _ = gemma
    mine = init_params(cfg, seed=3, device="cpu")
    want = jax.tree.map(lambda x: tuple(x.shape), rparams)
    got = jax.tree.map(lambda x: tuple(x.shape), mine)
    assert got == want
    assert float(mine["blocks"]["pos0"]["norm1"].abs().max()) == 0.0


def test_score_forward(gemma):
    rcfg, cfg, rparams, params = gemma
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want = ref_forward(rparams, rcfg, tokens=jnp.asarray(toks))
    got = forward(params, cfg, torch.from_numpy(toks))
    _logits_close(got.logits, want.logits)
    _close(got.hidden, want.hidden)


def test_prefill_writes_the_reference_caches(gemma):
    rcfg, cfg, rparams, params = gemma
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    want_logits, want_caches = ref_serve.make_prefill_step(rcfg)(
        rparams, ref_init_caches(rcfg, 2, 24), tokens=jnp.asarray(toks)
    )
    got_logits, got_caches = serve.make_prefill_step(cfg)(params, init_caches(cfg, 2, 24, "cpu"), torch.from_numpy(toks))
    _logits_close(got_logits, want_logits)
    _caches_close(got_caches, want_caches)
    # prefill_at reads the true last row of a right-padded prompt
    padded = np.zeros((1, 16), np.int32)
    padded[0, :9] = toks[0, :9]
    r_logits, r_hidden, _ = ref_serve.make_prefill_at_step(rcfg)(
        rparams, ref_init_caches(rcfg, 1, 24), jnp.asarray(padded), jnp.int32(9)
    )
    g_logits, g_hidden, _ = serve.make_prefill_at_step(cfg)(params, init_caches(cfg, 1, 24, "cpu"), torch.from_numpy(padded), 9)
    _logits_close(g_logits, r_logits)
    _close(g_hidden, r_hidden)


@pytest.mark.parametrize("cache_len", [5, [3, 20, 11]], ids=["scalar", "vector"])
def test_dense_decode(gemma, cache_len):
    """One decode step over a cache holding the same random rows in both
    frameworks (rows past 16 exercise the local layers' window of 16)."""
    rcfg, cfg, rparams, params = gemma
    rng = np.random.default_rng(2)
    b, max_len = 3, 32
    caches, rcaches = _random_caches(rng, ref_init_caches(rcfg, b, max_len))
    toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    if isinstance(cache_len, list):
        r_cl, p_cl = jnp.asarray(cache_len, jnp.int32), torch.tensor(cache_len, dtype=torch.int32)
    else:
        r_cl, p_cl = jnp.asarray(cache_len, jnp.int32), cache_len
    r_logits, r_hidden, r_caches = ref_serve.make_decode_step(rcfg, return_hidden=True)(
        rparams, rcaches, r_cl, tokens=jnp.asarray(toks)
    )
    g_logits, g_hidden, g_caches = serve.make_decode_step(cfg, return_hidden=True)(params, caches, p_cl, torch.from_numpy(toks))
    _logits_close(g_logits, r_logits)
    _close(g_hidden, r_hidden)
    _caches_close(g_caches, r_caches)


@pytest.mark.parametrize("impl", [None, "kernel"], ids=["gather-route", "kernel-wrapper-plain"])
def test_paged_decode(gemma, impl):
    """Paged decode through a permuted block table (page 8): the gather
    route and the kernel wrapper's plain version both match the reference's
    paged decode, written pages included."""
    rcfg, cfg, rparams, params = gemma
    rng = np.random.default_rng(3)
    b, page, nb = 3, 8, 4
    n_pages = b * nb + 1
    caches, rcaches = _random_caches(rng, ref_init_paged(rcfg, b, n_pages, page))
    tables = rng.permutation(np.arange(1, n_pages))[: b * nb].reshape(b, nb).astype(np.int32)
    cl = np.asarray([4, 27, 17], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    r_logits, r_hidden, r_caches = ref_serve.make_decode_step(rcfg, return_hidden=True)(
        rparams, rcaches, jnp.asarray(cl), tokens=jnp.asarray(toks), block_tables=jnp.asarray(tables)
    )
    g_logits, g_hidden, g_caches = serve.make_decode_step(cfg, return_hidden=True)(
        params, caches, torch.from_numpy(cl), torch.from_numpy(toks), block_tables=torch.from_numpy(tables), impl=impl
    )
    _logits_close(g_logits, r_logits)
    _close(g_hidden, r_hidden)
    _caches_close(g_caches, r_caches)
    assert set(init_paged_caches(cfg, n_pages, page, "cpu")) == set(r_caches)
