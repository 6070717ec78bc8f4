"""The port's LM training slice against the reference, on the CPU.

* ``lm_batch`` / ``lm_iterator``: bit-identical to the reference's.
* ``subsample_tokens`` and ``lm_decorrelation_loss`` (VICReg-style, R_sum
  ungrouped, R_sum b = 128 and the fused R_off, each with and without the
  permutation, on the plain route and the kernel route): the aux loss, its
  terms and its gradient wrt the hidden states within 5e-4 relative of the
  reference's, the reference's permutation handed in; disabled, a host zero.
* ``make_train_step``: the parameters and metrics after two steps (one and
  two microbatches, a dense arch and an MoE arch) within 5e-4 of the
  reference's.
* The launcher at ``--reduced --steps 4 --decorr --device cpu``: resuming
  from a checkpoint equals an uninterrupted run; ``--pretune analytic |
  dry | measure`` warms the aux loss's tuned choices; without ``--device
  cpu`` and no card, it raises.
* The aux loss lowers the hidden-state Eq. 16 metric (the twin of
  ``tests/test_system.py``'s framework-feature test).
* ``core/whitening`` and ``ServeEngine.from_checkpoint`` against the
  reference's.
"""

import dataclasses
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import save_checkpoint as ref_save  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.core import whitening as ref_whitening  # noqa: E402
from repro.core.decorrelation import LMDecorrConfig as RefLMDecorrConfig  # noqa: E402
from repro.core.decorrelation import lm_decorrelation_loss as ref_lm_loss  # noqa: E402
from repro.core.decorrelation import subsample_tokens as ref_subsample  # noqa: E402
from repro.data import LMDataConfig as RefLMDataConfig  # noqa: E402
from repro.data import lm_batch as ref_lm_batch  # noqa: E402
from repro.data import lm_iterator as ref_lm_iterator  # noqa: E402
from repro.decorr import DecorrConfig as RefDecorrConfig  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import clip_by_global_norm as ref_clip  # noqa: E402
from repro.optim import warmup_cosine as ref_warmup_cosine  # noqa: E402
from repro.serve.engine import ServeEngine as RefServeEngine  # noqa: E402
from repro.train import create_train_state as ref_create_state  # noqa: E402
from repro.train import make_train_step as ref_make_step  # noqa: E402
from repro.train.ssl import SSLModelConfig as RefModelConfig  # noqa: E402
from repro.train.ssl import init_ssl_params  # noqa: E402
from repro.train.step import _lm_loss_fn as ref_lm_loss_fn  # noqa: E402
from repro.train.train_state import TrainState as RefTrainState  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import LMDecorrConfig, lm_decorrelation_loss, subsample_tokens, whitening  # noqa: E402
from repro_torch.core.losses import normalized_bt_regularizer  # noqa: E402
from repro_torch.data import LMDataConfig, lm_batch, lm_iterator  # noqa: E402
from repro_torch.decorr import DecorrConfig, engine  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import ParamTree, forward, init_params, params_from_jax  # noqa: E402
from repro_torch.optim import adamw, warmup_cosine  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train import create_train_state, make_train_step  # noqa: E402
from repro_torch.train.ssl import SSLModelConfig  # noqa: E402
from repro_torch.train.ssl import params_from_jax as ssl_params_from_jax  # noqa: E402

RTOL = 5e-4
# the aux arms of the smoke's [lmtrain] phase (the R_off arm through the fused kernel)
AUX = {
    "sum": dict(style="vic", reg="sum", q=2),
    "sum-b128": dict(style="vic", reg="sum", q=2, block_size=128),
    "off": dict(style="vic", reg="off", use_kernel=True),
}


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


def _rel(got, want) -> float:
    """Max |got - want| relative to max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ref_perm(step, d, seed=0):
    """The reference step's permutation: fold_in(PRNGKey(seed), step)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    return torch.from_numpy(np.array(jax.random.permutation(key, d)))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(vocab_size=256, batch=4, seq_len=16),
                                dict(vocab_size=256000, batch=3, seq_len=9, seed=5),
                                dict(vocab_size=2048, batch=2, seq_len=7, seed=1, n_codebooks=4)],
                         ids=["small", "gemma-vocab", "audio-codes"])
def test_lm_batch_and_iterator_are_bit_identical(kw):
    cfg, ref = LMDataConfig(**kw), RefLMDataConfig(**kw)
    for step in (0, 3):
        got, want = lm_batch(cfg, step), ref_lm_batch(ref, step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    for got, want, _ in zip(lm_iterator(cfg, 2), ref_lm_iterator(ref, 2), range(3)):
        assert all(np.array_equal(got[k], want[k]) for k in got)


# ---------------------------------------------------------------------------
# core/decorrelation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,tps", [((2, 16, 8), 4), ((3, 5, 8), 8), ((2, 13, 8), 4)])
def test_subsample_tokens_matches_reference(shape, tps):
    h = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = subsample_tokens(torch.from_numpy(h), tps)
    want = np.asarray(ref_subsample(jnp.asarray(h), tps))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)


@functools.lru_cache(maxsize=None)
def _ref_aux(arm, permute):
    """The reference's aux loss, metrics and d aux / d hidden on one seeded
    (2, 16, 256) hidden-state batch."""
    h = np.random.default_rng(1).standard_normal((2, 16, 256)).astype(np.float32)
    h[..., :128] += 0.7 * h[..., 128:]  # correlated halves: R is far from 0
    cfg = RefLMDecorrConfig(enabled=True, decorr=RefDecorrConfig(**AUX[arm], permute=permute), nu=0.5)
    key = jax.random.PRNGKey(7)
    (aux, m), g = jax.value_and_grad(lambda x: ref_lm_loss(x, cfg, perm_key=key), has_aux=True)(jnp.asarray(h))
    perm = torch.from_numpy(np.array(jax.random.permutation(key, 256)))
    return h, perm, {k: float(v) for k, v in m.items()}, np.asarray(g)


@pytest.mark.parametrize("impl", [None, "kernel"], ids=["route-by-device", "kernel-route"])
@pytest.mark.parametrize("permute", [True, False], ids=["permute", "no-permute"])
@pytest.mark.parametrize("arm", list(AUX))
def test_lm_decorrelation_loss_matches_reference(arm, permute, impl):
    h, perm, want, want_grad = _ref_aux(arm, permute)
    cfg = LMDecorrConfig(enabled=True, decorr=DecorrConfig(**AUX[arm], permute=permute), nu=0.5)
    hidden = torch.from_numpy(h).requires_grad_()
    aux, metrics = lm_decorrelation_loss(hidden, cfg, perm, impl=impl)
    (grad,) = torch.autograd.grad(aux, hidden)
    assert set(metrics) == set(want) == {"decorr_aux", "decorr_var", "decorr_reg"}
    for k in want:
        assert _rel(float(metrics[k].detach()), want[k]) <= RTOL, k
    assert want["decorr_reg"] > 0
    assert _rel(grad.numpy(), want_grad) <= RTOL


@pytest.mark.parametrize("arm", list(AUX))
def test_aliased_operands_get_the_sum_of_both_vjps(arm):
    """``R(z, z)`` (the aux passes ``zc, zc``) through the kernels' autograd
    rules (their plain versions here): the gradient is the sum of both
    operands' vjps of ``R(z1, z2)`` at z1 = z2 = z."""
    from repro_torch.core import regularizers as regs
    from repro_torch.kernels.xcorr_offdiag import off_diagonal_sq_sum

    kw = AUX[arm]

    def reg(a, b):
        if kw["reg"] == "off":
            return off_diagonal_sq_sum(a, b, scale=63.0)
        return regs.r_sum_auto(a, b, q=2, block_size=kw.get("block_size"), scale=63.0, impl="kernel")

    base = torch.from_numpy(np.random.default_rng(2).standard_normal((64, 256)).astype(np.float32))
    z = base.clone().requires_grad_()
    (got,) = torch.autograd.grad(reg(z, z), z)
    z1, z2 = base.clone().requires_grad_(), base.clone().requires_grad_()
    g1, g2 = torch.autograd.grad(reg(z1, z2), (z1, z2))
    assert _rel(got.numpy(), (g1 + g2).numpy()) <= 1e-5


def test_disabled_aux_loss_is_a_host_zero():
    h = torch.randn(2, 8, 16)
    aux, metrics = lm_decorrelation_loss(h, LMDecorrConfig())
    want, _ = ref_lm_loss(jnp.asarray(h.numpy()), RefLMDecorrConfig())
    assert aux.device.type == "cpu" and float(aux) == float(want) == 0.0
    assert set(metrics) == {"decorr_aux"}
    with pytest.raises(ValueError, match="tokens_per_seq"):
        LMDecorrConfig(tokens_per_seq=0).validate()


def test_regularizer_ddof_changes_nothing_in_local_mode():
    z = torch.randn(12, 64)
    cfg = DecorrConfig(style="vic", reg="sum", q=2)
    perm = torch.randperm(64)
    assert torch.equal(engine.regularizer(z, z, cfg, 11.0, perm, ddof=1), engine.regularizer(z, z, cfg, 11.0, perm))
    with pytest.raises(ValueError, match="model_axis"):
        engine.regularizer(z, z, DecorrConfig(distributed="tp"), 11.0, ddof=1)


# ---------------------------------------------------------------------------
# the parameter container and the train step
# ---------------------------------------------------------------------------


def test_param_tree_holds_the_tree_as_parameters():
    cfg = get_config("jamba-v0.1-52b").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    mod = ParamTree(params)
    tree = mod.tree()
    flat = dict(mod.named_parameters())
    assert flat.keys() == mod.state_dict().keys()
    assert tree["blocks"]["pos1"]["moe"]["router"] is flat["blocks.pos1.moe.router"]
    assert all(p.is_leaf and p.requires_grad for p in flat.values())
    assert flat["embed"].data_ptr() == params["embed"].data_ptr()  # no copy
    toks = torch.from_numpy(lm_batch(LMDataConfig(cfg.vocab_size, 2, 8), 0)["tokens"])
    assert torch.equal(forward(tree, cfg, toks).logits, forward(params, cfg, toks).logits)


def _step_cfgs(arch):
    dk = AUX["sum"]
    rcfg = dataclasses.replace(ref_config(arch).reduced(), decorr=RefLMDecorrConfig(
        enabled=True, decorr=RefDecorrConfig(**dk), nu=0.5, tokens_per_seq=4))
    cfg = dataclasses.replace(get_config(arch).reduced(), decorr=LMDecorrConfig(
        enabled=True, decorr=DecorrConfig(**dk), nu=0.5, tokens_per_seq=4))
    return rcfg, cfg


@functools.lru_cache(maxsize=None)
def _ref_two_steps(arch, micro):
    rcfg, cfg = _step_cfgs(arch)
    opt = ref_adamw()
    state = ref_create_state(ref_init(jax.random.PRNGKey(0), rcfg), opt)
    init = jax.tree.map(np.asarray, state.params)
    step = jax.jit(ref_make_step(rcfg, opt, ref_warmup_cosine(3e-3, 0, 10), num_microbatches=micro))
    data = RefLMDataConfig(vocab_size=rcfg.vocab_size, batch=4, seq_len=8)
    metrics = []
    for s in range(2):
        state, m = step(state, {k: jnp.asarray(v) for k, v in ref_lm_batch(data, s).items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return init, jax.tree.map(np.asarray, state.params), metrics


@pytest.mark.parametrize("micro", [1, 2], ids=["one-microbatch", "two-microbatches"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "llama4-scout-17b-a16e"])
def test_two_train_steps_match_reference(arch, micro):
    init, want_params, want_metrics = _ref_two_steps(arch, micro)
    _, cfg = _step_cfgs(arch)
    opt = adamw()
    state = create_train_state(ParamTree(params_from_jax(cfg, init, device="cpu")), opt)
    step = make_train_step(cfg, opt, warmup_cosine(3e-3, 0, 10), num_microbatches=micro,
                           perm_fn=lambda s: _ref_perm(s, cfg.d_model))
    data = LMDataConfig(vocab_size=cfg.vocab_size, batch=4, seq_len=8)
    for s in range(2):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in lm_batch(data, s).items()})
        for k in ("loss", "ce", "moe_aux", "decorr_aux", "decorr_reg", "grad_norm", "lr"):
            assert abs(float(m[k]) - want_metrics[s][k]) <= RTOL * max(abs(want_metrics[s][k]), 1e-6), (s, k)
    assert state.step == 2
    moved = 0
    for name, p in state.model.named_parameters():
        want = functools.reduce(lambda t, k: t[k], name.split("."), want_params)
        before = functools.reduce(lambda t, k: t[k], name.split("."), init)
        # the parameters within 5e-4 of the reference's, relative to the
        # leaf's largest entry (not the update's: AdamW's first steps turn a
        # rounding-level gradient entry into a full-size step either way)
        got = p.detach().numpy()
        assert _rel(got, want) <= RTOL, name
        moved += int(not np.array_equal(got, before))
    assert moved > 0
    if arch.startswith("llama4"):
        assert want_metrics[0]["moe_aux"] > 0


def _bf16_cfgs():
    """Reduced gemma2-2b, aux on, with bf16 parameters and f32 compute."""
    rcfg, cfg = _step_cfgs("gemma2-2b")
    return (dataclasses.replace(rcfg, param_dtype=jnp.bfloat16, compute_dtype=jnp.float32),
            dataclasses.replace(cfg, param_dtype=torch.bfloat16, compute_dtype=torch.float32))


@functools.lru_cache(maxsize=None)
def _ref_bf16_steps(micro):
    """The reference's two steps on bf16 parameters: the initial tree, the
    (clipped) gradients its AdamW receives at step 0 and the parameters
    after both steps."""
    rcfg, _ = _bf16_cfgs()
    opt = ref_adamw()
    state = ref_create_state(ref_init(jax.random.PRNGKey(0), rcfg), opt)
    init = jax.tree.map(np.asarray, state.params)
    data = RefLMDataConfig(vocab_size=rcfg.vocab_size, batch=4, seq_len=8)
    batches = [{k: jnp.asarray(v) for k, v in ref_lm_batch(data, s).items()} for s in range(2)]
    # step 0 as ``make_train_step`` computes it: per-microbatch grads summed in f32
    rng0 = jax.random.fold_in(state.rng, 0)
    grad = jax.jit(jax.grad(lambda p, b: ref_lm_loss_fn(p, b, rcfg, rng0)[0]))
    if micro == 1:
        g0 = grad(state.params, batches[0])
    else:
        parts = [{k: v.reshape((micro, -1) + v.shape[1:])[i] for k, v in batches[0].items()} for i in range(micro)]
        g0 = jax.tree.map(lambda *g: sum(x.astype(jnp.float32) for x in g) / micro, *[grad(state.params, b) for b in parts])
    g0, _ = ref_clip(g0, 1.0)
    step = jax.jit(ref_make_step(rcfg, opt, ref_warmup_cosine(3e-3, 0, 10), num_microbatches=micro))
    for b in batches:
        state, _ = step(state, b)
    return init, jax.tree.map(np.asarray, g0), jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("micro", [1, 2], ids=["one-microbatch", "two-microbatches"])
def test_bf16_params_get_the_references_gradients_and_steps(micro):
    """bf16 parameters, f32 compute (every full config's dtypes): the clip
    and AdamW take the averaged f32 gradients of two microbatches (one
    microbatch: the parameters' dtype, as ``value_and_grad`` gives them),
    within one bf16 ulp (2^-8) of each leaf's largest entry of the
    reference's, and two steps land within 2e-2 of each leaf's largest
    entry: a few bf16 ulps (measured 5.2e-3 with one microbatch, 1.03e-2
    with two, `final_norm`; 5.0e-2 and 5.4e-2 before the f32 gradients
    and the once-rounded update).  AdamW's first steps turn a
    rounding-level gradient entry into a full-size step either way."""
    init, want_g0, want_params = _ref_bf16_steps(micro)
    _, cfg = _bf16_cfgs()
    opt = adamw()
    state = create_train_state(ParamTree(params_from_jax(cfg, init, device="cpu")), opt)
    assert all(p.dtype == torch.bfloat16 for p in state.model.parameters())
    seen = []
    update = state.opt_state.step

    def spy(lr, grads=None):
        seen.append([g.clone() for g in grads])
        return update(lr, grads)

    state.opt_state.step = spy
    step = make_train_step(cfg, opt, warmup_cosine(3e-3, 0, 10), num_microbatches=micro,
                           perm_fn=lambda s: _ref_perm(s, cfg.d_model))
    data = LMDataConfig(vocab_size=cfg.vocab_size, batch=4, seq_len=8)
    for s in range(2):
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in lm_batch(data, s).items()})
    leaf = lambda tree, name: functools.reduce(lambda t, k: t[k], name.split("."), tree)  # noqa: E731
    for (name, p), g in zip(state.model.named_parameters(), seen[0]):
        assert g.dtype == (torch.float32 if micro > 1 else p.dtype), name
        want = np.asarray(leaf(want_g0, name), np.float64)
        assert np.abs(g.double().numpy() - want).max() <= 2.0**-8 * np.abs(want).max(), name
        want = np.asarray(leaf(want_params, name), np.float64)
        assert _rel(p.detach().double().numpy(), want) <= 2e-2, (name, _rel(p.detach().double().numpy(), want))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


ARGS = ["--arch", "gemma2-2b", "--reduced", "--decorr", "--device", "cpu", "--batch", "4", "--seq", "16"]


def test_launcher_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    straight = launch.train(launch.parse_args(ARGS + ["--steps", "4"]))
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-interval", "2"]
    first = launch.train(launch.parse_args(ARGS + ["--steps", "2"] + ckpt))
    assert first.step == 2
    resumed = launch.train(launch.parse_args(ARGS + ["--steps", "4"] + ckpt))  # a new process's state, restored
    assert resumed.step == straight.step == 4
    for (name, a), (_, b) in zip(straight.model.state_dict().items(), resumed.model.state_dict().items()):
        assert torch.equal(a, b), name
    out = capsys.readouterr().out
    assert "decorr=" in out and "done at step 4" in out


@pytest.fixture
def fresh_tune_memo():
    """An empty tuning memo before and after: a measured pick must not
    reach the other tests of this process."""
    from repro_torch.tune import dispatch

    dispatch.clear_memory_cache()
    yield
    dispatch.clear_memory_cache()


@pytest.mark.parametrize("mode", ["analytic", "dry", "measure"])
def test_launcher_pretune_warms_the_aux_shapes(mode, tmp_path, monkeypatch, capsys, fresh_tune_memo):
    """``--pretune`` warms the aux loss's tuned choices (batch *
    tokens_per_seq rows of width d_model, the reference's shapes) before
    the first step: afterwards ``best_config`` answers from the memo, and
    with the cache in a temp directory nothing lands on disk."""
    from repro_torch.tune import dispatch

    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path))
    state = launch.train(launch.parse_args(ARGS + ["--steps", "1", "--pretune", mode]))
    assert state.step == 1
    out = capsys.readouterr().out
    jobs = int(re.search(r"pre-tuned (\d+) decorr kernel shapes \(" + mode, out).group(1))
    # the measured picks may change the derived shapes; the analytic and dry ones are fixed
    assert jobs == 14 if mode != "measure" else jobs > 0
    searches = []
    monkeypatch.setattr(dispatch, "_analytic_search", lambda *a: searches.append(a))
    d = get_config("gemma2-2b").reduced().d_model
    assert dispatch.best_config("sumvec_fft_plan", (d,)) and searches == []
    assert list(tmp_path.iterdir()) == []


def test_launcher_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.train(launch.parse_args(["--reduced", "--steps", "1"]))


def test_vision_stub_batch_is_seeded_per_step():
    cfg = get_config("qwen2-vl-2b").reduced()
    fn = launch.lm_batch_fn(cfg, LMDataConfig(cfg.vocab_size, 2, 8, seed=3), "cpu")
    a, b, c = fn(1), fn(1), fn(2)
    assert set(a) == {"embeds", "positions", "labels"} and a["positions"].shape == (3, 2, 8)
    assert torch.equal(a["embeds"], b["embeds"]) and not torch.equal(a["embeds"], c["embeds"])


def test_lm_decorr_aux_reduces_hidden_correlation():
    """The framework feature (twin of the reference's system test): the
    VICReg-style R_sum aux on an assigned arch's hidden states lowers their
    correlation against the same run without it, without wrecking the LM
    loss."""

    def run(enabled):
        cfg = dataclasses.replace(
            get_config("codeqwen1.5-7b").reduced(),
            decorr=LMDecorrConfig(enabled=enabled, decorr=DecorrConfig(style="vic", reg="sum", q=2),
                                  mu=1.0, nu=2.0, tokens_per_seq=16),
        )
        opt = adamw(weight_decay=0.0)
        state = create_train_state(ParamTree(init_params(cfg, seed=0, device="cpu")), opt)
        step = make_train_step(cfg, opt, warmup_cosine(3e-3, 5, 80))
        data = LMDataConfig(vocab_size=cfg.vocab_size, batch=8, seq_len=32)
        for i in range(80):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in lm_batch(data, i).items()})
        with torch.no_grad():
            h = forward(state.model.tree(), cfg, torch.from_numpy(lm_batch(data, 999)["tokens"])).hidden
        h = h.reshape(-1, cfg.d_model)
        return float(normalized_bt_regularizer(h, h + 0.0)), float(m["ce"])

    q_on, ce_on = run(True)
    q_off, ce_off = run(False)
    assert q_on < q_off, (q_on, q_off)
    assert ce_on < ce_off * 1.25


# ---------------------------------------------------------------------------
# core/whitening
# ---------------------------------------------------------------------------


def _views():
    rng = np.random.default_rng(3)
    z1 = rng.standard_normal((64, 24)).astype(np.float32)
    return z1, (z1 + 0.3 * rng.standard_normal(z1.shape)).astype(np.float32)


@pytest.mark.parametrize("iters", [3, 7])
def test_newton_schulz_inv_sqrt_matches_reference(iters):
    z1, _ = _views()
    cov = (z1.T @ z1 / 63).astype(np.float32)
    got = whitening.newton_schulz_inv_sqrt(torch.from_numpy(cov), iters=iters)
    assert _rel(got.numpy(), ref_whitening.newton_schulz_inv_sqrt(jnp.asarray(cov), iters=iters)) <= RTOL


def test_zca_whiten_and_wmse_match_reference():
    z1, z2 = _views()
    white = whitening.zca_whiten(torch.from_numpy(z1))
    assert _rel(white.numpy(), ref_whitening.zca_whiten(jnp.asarray(z1))) <= RTOL
    cov = np.cov(white.numpy(), rowvar=False)
    assert np.abs(cov - np.eye(24)).max() < 0.05  # (nearly) white
    loss, m = whitening.wmse_loss(torch.from_numpy(z1), torch.from_numpy(z2))
    want, _ = ref_whitening.wmse_loss(jnp.asarray(z1), jnp.asarray(z2))
    assert _rel(float(loss), float(want)) <= RTOL and m["wmse_loss"] is loss


# ---------------------------------------------------------------------------
# ServeEngine.from_checkpoint
# ---------------------------------------------------------------------------


WIDTHS = dict(input_dim=32, backbone_widths=(48,), projector_widths=(64, 64))


@pytest.mark.parametrize("layout", ["train-state", "bare-params"])
def test_from_checkpoint_serves_what_the_reference_serves(tmp_path, layout):
    rparams = init_ssl_params(jax.random.PRNGKey(4), RefModelConfig(**WIDTHS))
    older = init_ssl_params(jax.random.PRNGKey(9), RefModelConfig(**WIDTHS))
    for step, tree in ((1, older), (3, rparams)):  # step=None must take the newest, 3
        model = ssl_params_from_jax(jax.tree.map(np.asarray, tree), SSLModelConfig(**WIDTHS))
        if layout == "train-state":
            ref_save(str(tmp_path / "ref"), step, RefTrainState(jnp.asarray(step), tree, {"m": tree},
                                                                jax.random.PRNGKey(0)))
            save_checkpoint(str(tmp_path / "port"), step, create_train_state(model, adamw()).state_dict())
        else:
            ref_save(str(tmp_path / "ref"), step, tree)
            save_checkpoint(str(tmp_path / "port"), step, model.state_dict())
    x = np.random.default_rng(5).standard_normal((7, 32)).astype(np.float32)
    want = np.asarray(RefServeEngine.from_checkpoint(str(tmp_path / "ref"), RefModelConfig(**WIDTHS)).encode(x))
    eng = ServeEngine.from_checkpoint(str(tmp_path / "port"), SSLModelConfig(**WIDTHS), device="cpu")  # newest: 3
    got = eng.encode(x).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, float(np.abs(want).max())))
    old = ServeEngine.from_checkpoint(str(tmp_path / "port"), SSLModelConfig(**WIDTHS), step=1, device="cpu")
    want_old = RefServeEngine.from_checkpoint(str(tmp_path / "ref"), RefModelConfig(**WIDTHS), step=1).encode(x)
    np.testing.assert_allclose(old.encode(x).numpy(), np.asarray(want_old), rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want_old).max())))
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        ServeEngine.from_checkpoint(str(tmp_path / "empty"), SSLModelConfig(**WIDTHS), device="cpu")


# ---------------------------------------------------------------------------
# per-layer rematerialisation and bf16 AdamW moments
# ---------------------------------------------------------------------------


def _loss_and_grads(cfg, tree, batch, perm):
    from repro_torch.train.step import _lm_loss_fn

    model = ParamTree({k: v for k, v in tree.items()})
    params = list(model.parameters())
    loss, _ = _lm_loss_fn(model.tree(), batch, cfg, perm)
    return float(loss), [g.detach() for g in torch.autograd.grad(loss, params)]


@pytest.mark.parametrize("arch", ["gemma2-2b", "llama4-scout-17b-a16e", "jamba-v0.1-52b", "rwkv6-3b"])
def test_remat_policies_give_the_same_loss_and_gradients(arch):
    """remat off, on (save nothing) and on with ``dots`` saved: one loss
    and one gradient, within 1e-6 relative (the recomputation repeats the
    forward's arithmetic)."""
    _, cfg = _step_cfgs(arch)
    tree = init_params(cfg, seed=1, device="cpu")
    data = LMDataConfig(vocab_size=cfg.vocab_size, batch=4, seq_len=8)
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(data, 0).items()}
    perm = _ref_perm(0, cfg.d_model)
    want_loss, want = _loss_and_grads(dataclasses.replace(cfg, remat=False), tree, batch, perm)
    for policy in ("nothing", "dots"):
        loss, grads = _loss_and_grads(dataclasses.replace(cfg, remat=True, remat_policy=policy), tree, batch, perm)
        assert abs(loss - want_loss) <= 1e-6 * abs(want_loss), policy
        for g, w in zip(grads, want):
            assert _rel(g.numpy(), w.numpy()) <= 1e-6, policy


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_train_steps_hold_the_reference(policy):
    """Remat on, as the reference's configs have it, holds the reference's
    two steps (themselves under ``jax.checkpoint``) at the existing 5e-4."""
    init, want_params, want_metrics = _ref_two_steps("gemma2-2b", 1)
    rcfg, cfg = _step_cfgs("gemma2-2b")
    assert rcfg.remat and cfg.remat and rcfg.remat_policy == cfg.remat_policy == "nothing"
    cfg = dataclasses.replace(cfg, remat_policy=policy)
    opt = adamw()
    state = create_train_state(ParamTree(params_from_jax(cfg, init, device="cpu")), opt)
    step = make_train_step(cfg, opt, warmup_cosine(3e-3, 0, 10), perm_fn=lambda s: _ref_perm(s, cfg.d_model))
    data = LMDataConfig(vocab_size=cfg.vocab_size, batch=4, seq_len=8)
    for s in range(2):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in lm_batch(data, s).items()})
        for k in ("loss", "ce", "decorr_aux", "grad_norm"):
            assert abs(float(m[k]) - want_metrics[s][k]) <= RTOL * max(abs(want_metrics[s][k]), 1e-6), (s, k)
    for name, p in state.model.named_parameters():
        want = functools.reduce(lambda t, k: t[k], name.split("."), want_params)
        assert _rel(p.detach().numpy(), want) <= RTOL, name


def test_analyzer_flops_order_remat_nothing_dots_off():
    """The op-level analyzer sees the recomputation: saving nothing re-runs
    every block's products in the backward pass; ``dots`` saves them (its
    product FLOPs are the no-remat step's: the analyzer counts products
    only, and ``dots`` recomputes the rest) and holds more bytes alive than
    saving nothing; no remat holds the most."""
    from repro_torch.launch import hlo_cost

    _, cfg = _step_cfgs("gemma2-2b")
    cfg = dataclasses.replace(cfg, d_model=128, d_ff=512, n_layers=6)
    tree = init_params(cfg, device="cpu")
    data = LMDataConfig(vocab_size=cfg.vocab_size, batch=4, seq_len=32)
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(data, 0).items()}
    perm = _ref_perm(0, cfg.d_model)
    from repro_torch.train.step import _lm_loss_fn

    def grads(c, t, b, p):
        model = ParamTree(t)
        return torch.autograd.grad(_lm_loss_fn(model.tree(), b, c, p)[0], list(model.parameters()))

    got = {}
    for name, kw in (("nothing", dict(remat=True)), ("dots", dict(remat=True, remat_policy="dots")),
                     ("off", dict(remat=False))):
        got[name] = hlo_cost.analyze(grads, dataclasses.replace(cfg, **kw), tree, batch, perm)
    flops = {k: a.product_flops for k, a in got.items()}
    temp = {k: a.temp_bytes for k, a in got.items()}
    print(f"remat product flops {flops} temp bytes {temp}")
    assert flops["nothing"] > flops["dots"] >= flops["off"], flops
    assert temp["nothing"] < temp["dots"] < temp["off"], temp


def test_adamw_bf16_moments_within_one_ulp_of_the_reference():
    """``adamw(moment_dtype=bf16)``: bf16 moments, and after two steps on
    the same gradients the parameters within one bf16 ulp of the
    reference's ``adamw(moment_dtype=jnp.bfloat16)``."""
    rng = np.random.default_rng(11)
    shapes = {"w": (8, 16), "b": (16,)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in shapes.items()} for _ in range(2)]
    ropt = ref_adamw(moment_dtype=jnp.bfloat16)
    rparams = {k: jnp.asarray(v) for k, v in init.items()}
    rstate = ropt.init(rparams)
    for g in grads:
        rparams, rstate = ropt.update({k: jnp.asarray(v) for k, v in g.items()}, rstate, rparams, 1e-2)
    assert all(v.dtype == jnp.bfloat16 for v in jax.tree.leaves((rstate["m"], rstate["v"])))

    params = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in shapes]
    opt = adamw(moment_dtype=torch.bfloat16).init(params)
    for g in grads:
        opt.step(1e-2, [torch.from_numpy(g[k]) for k in shapes])
    for p, k in zip(params, shapes):
        assert opt.state[p]["m"].dtype == opt.state[p]["v"].dtype == torch.bfloat16
        np.testing.assert_array_equal(opt.state[p]["m"].float().numpy(), np.asarray(rstate["m"][k], np.float32))
        want = np.asarray(rparams[k], np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
        assert np.all(np.abs(p.detach().numpy() - want) <= ulp), k
