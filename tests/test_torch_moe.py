"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on reduced arctic-480b (top-2 + dense residual),
llama4-scout (top-1 + shared expert) and jamba (top-2), with the
reference's own expert weights: the one-group and the grouped
(``moe_group_size=8``) dispatch, and ``capacity_factor=0.5``, where the
capacity forces drops.  Output and aux loss within 1e-5."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = 1e-5
ARCHS = ("arctic-480b", "llama4-scout-17b-a16e", "jamba-v0.1-52b")
# the reference's functions compiled whole (one compile a config, not one
# an op): the same computation, a fraction of the test's time
ref_moe_init = jax.jit(ref_moe.moe_init, static_argnums=1)
ref_moe_apply = jax.jit(ref_moe.moe_apply, static_argnums=2)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.asarray(v).copy())
            for k, v in tree.items()}


def _configs(arch, **kw):
    return ref_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize(
    "kw",
    [{}, dict(moe_group_size=8), dict(capacity_factor=0.5), dict(capacity_factor=0.5, moe_group_size=8)],
    ids=["one-group", "grouped", "drops", "grouped-cf0.5"],
)
def test_moe_apply_matches_the_reference(arch, kw):
    rcfg, cfg = _configs(arch, **kw)
    rparams = ref_moe_init(jax.random.PRNGKey(3), rcfg)
    x = np.random.default_rng(0).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    want, want_aux = ref_moe_apply(rparams, jnp.asarray(x), rcfg)
    got, aux = moe.moe_apply(_to_torch(rparams), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0, atol=TOL)
    if kw == dict(capacity_factor=0.5):
        # the capacity bites: with room for every token the output differs
        ample, _ = moe.moe_apply(_to_torch(rparams), torch.from_numpy(x),
                                 dataclasses.replace(cfg, capacity_factor=8.0))
        assert not np.allclose(ample.numpy(), got.numpy())


def test_grouped_dispatch_runs_only_on_whole_groups():
    """``moe_group_size`` takes effect when the tokens split into more than
    one whole group; 24 tokens at G = 16 route as one group, as the
    reference does."""
    rcfg, cfg = _configs("llama4-scout-17b-a16e", moe_group_size=16, capacity_factor=0.5)
    rparams = ref_moe_init(jax.random.PRNGKey(4), rcfg)
    params = _to_torch(rparams)
    x = np.random.default_rng(1).standard_normal((1, 24, cfg.d_model)).astype(np.float32)
    want, _ = ref_moe_apply(rparams, jnp.asarray(x), rcfg)
    got, _ = moe.moe_apply(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    one, _ = moe.moe_apply(params, torch.from_numpy(x), dataclasses.replace(cfg, moe_group_size=None))
    np.testing.assert_array_equal(got.numpy(), one.numpy())


def test_top_k_breaks_ties_to_the_lower_expert_as_lax_top_k():
    probs = np.asarray([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4], [0.3, 0.2, 0.3, 0.2]], np.float32)
    for k in (1, 2, 3):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = moe._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("tokens", [1, 7, 32, 4096])
def test_capacity_matches_the_reference(tokens):
    for arch in ARCHS:
        rcfg, cfg = _configs(arch)
        assert moe._capacity(tokens, cfg) == ref_moe._capacity(tokens, rcfg)
