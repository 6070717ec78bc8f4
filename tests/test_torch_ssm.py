"""The port's recurrent mixers (``repro_torch.models.ssm``) against the
reference's ``repro.models.ssm`` with the reference's own weights: Mamba's
full scan, prefill from a carried state and one-step decode on reduced
jamba; RWKV6's sequential scan, its chunk-parallel prefill
(``reduced(rwkv_chunk=8)``: 24 tokens take the chunked path, 20 the scan)
and one-step decode on reduced rwkv6-3b, time mix and channel mix.  Outputs
and carried states within 1e-5; the chunked path also against the
sequential scan within the reference's own bound for it (1e-4 of the
largest output)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = 1e-5
# the reference's functions compiled whole (one compile a shape, not one an
# op): the same computation, a fraction of the test's time
ref_mamba_init = jax.jit(ref_ssm.mamba_init, static_argnums=1)
ref_rwkv_init = jax.jit(ref_ssm.rwkv_init, static_argnums=1)
ref_mamba_apply = jax.jit(ref_ssm.mamba_apply, static_argnums=2)
ref_time_mix = jax.jit(ref_ssm.rwkv_time_mix, static_argnums=2)
ref_channel_mix = jax.jit(ref_ssm.rwkv_channel_mix, static_argnums=2)
ref_chunked = jax.jit(ref_ssm._rwkv_chunked, static_argnums=6, static_argnames=("decay_is_log",))


def _to_torch(tree):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in tree.items()}


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _states_close(got, want):
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k])


def _random_state(rng, ref_state):
    """The same random state (batch 2) in both frameworks."""
    vals = {k: rng.standard_normal((2,) + v.shape[1:]).astype(np.float32) * 0.5 for k, v in ref_state.items()}
    return {k: torch.from_numpy(v.copy()) for k, v in vals.items()}, {k: jnp.asarray(v) for k, v in vals.items()}


@pytest.fixture(scope="module")
def mamba():
    rcfg = ref_config("jamba-v0.1-52b").reduced()
    cfg = get_config("jamba-v0.1-52b").reduced()
    rparams = ref_mamba_init(jax.random.PRNGKey(1), rcfg)
    return rcfg, cfg, rparams, _to_torch(rparams)


@pytest.fixture(scope="module")
def rwkv():
    rcfg = ref_config("rwkv6-3b").reduced(rwkv_chunk=8)
    cfg = get_config("rwkv6-3b").reduced(rwkv_chunk=8)
    rparams = ref_rwkv_init(jax.random.PRNGKey(2), rcfg)
    return rcfg, cfg, rparams, _to_torch(rparams)


@pytest.mark.parametrize("mode,s", [("full", 12), ("prefill", 12), ("prefill", 2), ("decode", 1)],
                         ids=["full", "prefill", "prefill-short", "decode"])
def test_mamba_matches_the_reference(mamba, mode, s):
    """``prefill-short``: fewer tokens than the conv's carried tail."""
    rcfg, cfg, rparams, params = mamba
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    state, rstate = (None, None)
    if mode != "full":
        state, rstate = _random_state(rng, ref_ssm.mamba_init_state(rcfg, 1))
    want, want_state = ref_mamba_apply(rparams, jnp.asarray(x), rcfg, rstate)
    got, got_state = ssm.mamba_apply(params, torch.from_numpy(x), cfg, state)
    _close(got.numpy(), want)
    if mode == "full":
        assert got_state is None and want_state is None
    else:
        _states_close(got_state, want_state)


@pytest.mark.parametrize("mode,s", [("scan", 20), ("chunked", 24), ("prefill-scan", 20), ("prefill-chunked", 24),
                                    ("decode", 1)])
def test_rwkv_time_and_channel_mix_match_the_reference(rwkv, mode, s):
    rcfg, cfg, rparams, params = rwkv
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    state, rstate = (None, None)
    if mode.startswith("prefill") or mode == "decode":
        state, rstate = _random_state(rng, ref_ssm.rwkv_init_state(rcfg, 1))
    want, want_state = ref_time_mix(rparams, jnp.asarray(x), rcfg, rstate)
    got, got_state = ssm.rwkv_time_mix(params, torch.from_numpy(x), cfg, state)
    _close(got.numpy(), want)
    want_c, want_state = ref_channel_mix(rparams, jnp.asarray(x), rcfg, want_state)
    got_c, got_state = ssm.rwkv_channel_mix(params, torch.from_numpy(x), cfg, got_state)
    _close(got_c.numpy(), want_c)
    if state is None:
        assert got_state is None and want_state is None
    else:
        _states_close(got_state, want_state)


def test_rwkv_chunked_matches_the_reference_and_the_scan():
    """``_rwkv_chunked`` against the reference's on the same inputs, and
    against the sequential recurrence within the reference's bound (1e-4 of
    the largest output)."""
    rng = np.random.default_rng(7)
    b, s, h, hd, chunk = 2, 32, 2, 8, 8
    r, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.standard_normal((b, s, h, hd)).astype(np.float32) - 1.0)
    u = rng.standard_normal((h, hd)).astype(np.float32) * 0.1
    s0 = rng.standard_normal((b, h, hd, hd)).astype(np.float32) * 0.5
    want_s, want_y = ref_chunked(*(jnp.asarray(t) for t in (r, k, v, logw, u, s0)), chunk,
                                           decay_is_log=True)
    got_s, got_y = ssm._rwkv_chunked(*(torch.from_numpy(t) for t in (r, k, v, logw, u, s0)), chunk)
    tol = TOL * max(1.0, float(np.abs(np.asarray(want_y)).max()))
    _close(got_y.numpy(), want_y, atol=tol)
    _close(got_s.numpy(), want_s, atol=tol)
    state = torch.from_numpy(s0)
    ys = []
    for t in range(s):
        state, y = ssm._wkv_step(state, *(torch.from_numpy(a[:, t]) for a in (r, k, v, np.exp(logw))),
                                 torch.from_numpy(u))
        ys.append(y)
    seq = torch.stack(ys, dim=1).numpy()
    assert np.abs(got_y.numpy() - seq).max() < 1e-4 * np.abs(seq).max()
    assert np.abs(got_s.numpy() - state.numpy()).max() < 1e-4 * np.abs(state.numpy()).max()
