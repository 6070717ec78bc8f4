"""Step 0 of LM training for all ten archs against the reference, on the CPU.

For each arch of ``repro_torch.configs`` at ``reduced()`` widths, with the
reference's own weights (``params_from_jax``), the launcher's batch (the
vision stub's embeddings and M-RoPE positions included) and the
reference's permutation handed in, the LM loss with the decorrelation aux
on (VICReg-style R_sum, q = 2):

  * its terms — loss, ce, moe_aux (x ``router_aux_weight``), decorr_aux —
    within 5e-4 relative of the reference's ``_lm_loss_fn``;
  * the gradient of every parameter leaf within 5e-4 of the reference's,
    relative to that leaf's largest entry (or to 1e-3 of the largest over
    all leaves, for a leaf whose gradient is near zero in exact
    arithmetic, so rounding noise is not read as a relative error of 1).

The reference's loss is ``jax.jit``-compiled whole (one compile an arch).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.decorrelation import LMDecorrConfig as RefLMDecorrConfig  # noqa: E402
from repro.decorr import DecorrConfig as RefDecorrConfig  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.train.step import _lm_loss_fn as ref_loss_fn  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core import LMDecorrConfig  # noqa: E402
from repro_torch.data import LMDataConfig  # noqa: E402
from repro_torch.decorr import DecorrConfig  # noqa: E402
from repro_torch.launch.train import lm_batch_fn  # noqa: E402
from repro_torch.models import ParamTree, params_from_jax  # noqa: E402
from repro_torch.train.step import _lm_loss_fn  # noqa: E402

RTOL = 5e-4
TERMS = ("loss", "ce", "moe_aux", "decorr_aux")
AUX = dict(style="vic", reg="sum", q=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: under the parallel test workers
    torch's default pool (a thread a core in every worker) oversubscribes
    the cores, and the many small ops of a CPU train step then run ~100x
    slower (the 80-step aux test: 275 s against 3 s, six runs at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list_archs())
def step0(request):
    """(port metrics, port grads by leaf path, reference metrics, reference
    grads by leaf path) of one arch's step-0 LM loss."""
    arch = request.param
    rcfg = dataclasses.replace(ref_config(arch).reduced(), decorr=RefLMDecorrConfig(
        enabled=True, decorr=RefDecorrConfig(**AUX), nu=0.5, tokens_per_seq=4))
    cfg = dataclasses.replace(get_config(arch).reduced(), decorr=LMDecorrConfig(
        enabled=True, decorr=DecorrConfig(**AUX), nu=0.5, tokens_per_seq=4))
    data = LMDataConfig(cfg.vocab_size, batch=2, seq_len=8, seed=1,
                        n_codebooks=cfg.n_codebooks if cfg.frontend == "audio_codes" else 0)
    batch = lm_batch_fn(cfg, data, "cpu")(0)
    key = jax.random.PRNGKey(3)

    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    grad_fn = jax.jit(jax.value_and_grad(functools.partial(ref_loss_fn, cfg=rcfg), has_aux=True))
    (_, rm), rg = grad_fn(rparams, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, rng=key)
    ref_grads = {".".join(str(k.key) for k in path): np.asarray(g)
                 for path, g in jax.tree_util.tree_flatten_with_path(rg)[0]}

    model = ParamTree(params_from_jax(cfg, jax.tree.map(np.asarray, rparams), device="cpu"))
    perm = torch.from_numpy(np.array(jax.random.permutation(key, cfg.d_model)))
    loss, metrics = _lm_loss_fn(model.tree(), batch, cfg, perm)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return ({k: float(v.detach()) for k, v in metrics.items()}, {n: g.numpy() for n, g in zip(names, grads)},
            {k: float(v) for k, v in rm.items()}, ref_grads)


def test_loss_terms_match_reference(step0):
    got, _, want, _ = step0
    for k in TERMS:
        assert abs(got[k] - want[k]) <= RTOL * max(abs(want[k]), 1e-6), (k, got[k], want[k])
    assert want["decorr_aux"] > 0


def test_every_parameter_gradient_matches_reference(step0):
    _, grads, _, want = step0
    assert grads.keys() == want.keys()
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want.values())
    for name, g in grads.items():
        w = want[name]
        scale = max(float(np.abs(w).max()), floor)
        assert float(np.abs(g - w).max()) <= RTOL * scale, name
