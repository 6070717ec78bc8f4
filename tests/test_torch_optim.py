"""``repro_torch.optim`` against ``repro.optim``: five updates of each
optimizer on identical parameters, gradients and learning rates; the
gradient utilities and the schedule.  Elementwise f32 arithmetic in the
same order: tolerance 1e-6 relative (atol 1e-7)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.optim import optimizers as ropt  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"w": (6, 4), "b": (4,), "v": (3, 5)}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize(
    "name,kw",
    [
        ("lars", {}),
        ("lars", dict(momentum=0.5, weight_decay=1e-2, trust_coefficient=0.01)),
        ("adamw", {}),
        ("adamw", dict(b1=0.8, b2=0.99, weight_decay=0.0)),
        ("sgd_momentum", dict(weight_decay=1e-3)),
    ],
)
def test_five_updates_match_reference(name, kw):
    rng = np.random.default_rng(len(name) + len(kw))
    params = _tree(rng)
    params["zero"] = np.zeros((2, 2), np.float32)  # LARS: a zero norm keeps trust 1
    ref = getattr(ropt, name)(**kw)
    ref_params = {k: jnp.asarray(v) for k, v in params.items()}
    ref_state = ref.init(ref_params)
    port_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    port = getattr(topt, name)(**kw).init(port_params.values())
    for step in range(5):
        grads = _tree(rng, scale=0.1 * (step + 1))
        grads["zero"] = rng.standard_normal((2, 2)).astype(np.float32)
        lr = 0.05 * (step + 1)
        ref_params, ref_state = ref.update({k: jnp.asarray(v) for k, v in grads.items()}, ref_state, ref_params, lr)
        for k, p in port_params.items():
            p.grad = torch.from_numpy(grads[k])
        port.step(lr)
        for k in params:
            np.testing.assert_allclose(port_params[k].numpy(), np.asarray(ref_params[k]), **TOL, err_msg=f"{k} @ {step}")


def test_state_dict_holds_every_buffer_from_the_start():
    """Buffers exist before the first step, so a checkpoint template made
    from a fresh optimizer has the structure of a trained one's."""
    p = torch.zeros(3, 2, requires_grad=True)
    opt = topt.lars().init([p])
    assert set(opt.state_dict()["state"][0]) == {"mu"}
    opt2 = topt.adamw().init([p])
    assert set(opt2.state_dict()["state"][0]) == {"m", "v"}


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "passes"])
def test_global_norm_and_clip_match_reference(max_norm):
    grads = _tree(np.random.default_rng(1))
    want, want_norm = ropt.clip_by_global_norm({k: jnp.asarray(v) for k, v in grads.items()}, max_norm)
    got, got_norm = topt.clip_by_global_norm([torch.from_numpy(v) for v in grads.values()], max_norm)
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
    np.testing.assert_allclose(float(topt.global_norm(got)), float(ropt.global_norm(want)), rtol=1e-6)
    for g, k in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), **TOL)


def test_warmup_cosine_matches_reference():
    ref = ropt.warmup_cosine(0.2, 10, 100)
    port = topt.warmup_cosine(0.2, 10, 100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-6, err_msg=str(step))
