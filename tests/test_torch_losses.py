"""``repro_torch.decorr.engine.apply`` and ``repro_torch.core.losses``
against the reference, on seeded numpy views.

Loss, every metric and the gradients with respect to both views are held
to 5e-4 relative (the reference's loss tolerance,
``tests/test_decorr_engine.py``) across style x reg x b x q x use_kernel.
The reference draws the step's permutation from a PRNG key; the port gets
the same indices (``jax.random.permutation(key, d)``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import losses as rloss  # noqa: E402
from repro.decorr import DecorrConfig as RefConfig  # noqa: E402
from repro.decorr import engine as reng  # noqa: E402
from repro_torch.core import losses as tloss  # noqa: E402
from repro_torch.decorr import DecorrConfig, apply, variance_hinge  # noqa: E402

RTOL = 5e-4
N, D = 12, 32
KEY = jax.random.PRNGKey(7)


def _views(seed=0):
    rng = np.random.default_rng(seed)
    z1 = rng.standard_normal((N, D)).astype(np.float32)
    return z1, (0.6 * z1 + 0.8 * rng.standard_normal((N, D))).astype(np.float32)


CASES = [
    dict(style=style, reg="sum", block_size=b, q=q, use_kernel=k)
    for style in ("bt", "vic")
    for b in (None, 8)
    for q in (1, 2)
    for k in (False, True)
] + [dict(style=style, reg="off", use_kernel=k) for style in ("bt", "vic") for k in (False, True)]


def _id(kw):
    return "-".join(f"{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("kw", CASES, ids=[_id(kw) for kw in CASES])
def test_apply_loss_metrics_and_grads_match_reference(kw):
    z1, z2 = _views(seed=len(_id(kw)))
    ref_cfg = RefConfig(**kw)

    def ref_loss(a, b):
        return reng.apply(a, b, ref_cfg, KEY)

    (want, want_m), want_g = jax.value_and_grad(ref_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(z1), jnp.asarray(z2)
    )
    perm = torch.from_numpy(np.array(jax.random.permutation(KEY, D)))
    t1, t2 = (torch.from_numpy(z).requires_grad_() for z in (z1, z2))
    got, got_m = apply(t1, t2, DecorrConfig(**kw), perm)
    got_g = torch.autograd.grad(got, (t1, t2))

    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    assert sorted(got_m) == sorted(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k].detach()), float(want_m[k]), rtol=RTOL, atol=1e-6)
    for g, w in zip(got_g, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=RTOL * np.abs(w).max())


@pytest.mark.parametrize("style", ["bt", "vic"])
def test_loss_shims_dispatch_like_the_reference(style):
    z1, z2 = _views(seed=3)
    cfg = dict(style=style, reg="sum", block_size=8, q=2)
    perm = torch.from_numpy(np.array(jax.random.permutation(KEY, D)))
    t1, t2 = torch.from_numpy(z1), torch.from_numpy(z2)
    shim = tloss.barlow_twins_loss if style == "bt" else tloss.vicreg_loss
    ref_shim = rloss.barlow_twins_loss if style == "bt" else rloss.vicreg_loss
    want = float(ref_shim(jnp.asarray(z1), jnp.asarray(z2), RefConfig(**cfg), KEY)[0])
    for fn in (shim, tloss.ssl_loss):
        np.testing.assert_allclose(float(fn(t1, t2, DecorrConfig(**cfg), perm)[0]), want, rtol=RTOL)


def test_normalizations_and_eq16_eq17_match_reference():
    z1, z2 = _views(seed=5)
    j1, j2, t1, t2 = jnp.asarray(z1), jnp.asarray(z2), torch.from_numpy(z1), torch.from_numpy(z2)
    np.testing.assert_allclose(tloss.standardize(t1).numpy(), np.asarray(rloss.standardize(j1)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tloss.center(t1).numpy(), np.asarray(rloss.center(j1)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tloss.normalized_bt_regularizer(t1, t2)),
                               float(rloss.normalized_bt_regularizer(j1, j2)), rtol=RTOL)
    np.testing.assert_allclose(float(tloss.normalized_vic_regularizer(t1, t2)),
                               float(rloss.normalized_vic_regularizer(j1, j2)), rtol=RTOL)
    cfg = DecorrConfig(gamma=1.5)
    np.testing.assert_allclose(float(variance_hinge(t1, cfg)),
                               float(reng.variance_hinge(j1, RefConfig(gamma=1.5), "local")), rtol=RTOL)
