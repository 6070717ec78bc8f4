"""The port's SSL training slice against the reference, on the CPU.

* ``ssl_batch``: bit-identical to the reference's.
* 20-step loss curves of ``make_ssl_train_step`` (tiny config, LARS,
  warmup-cosine) against the reference's, from the same parameters,
  batches and per-step permutations, for the three arms of the smoke's
  train phase — (a) BT, R_sum, b = 128, q = 2; (b) VICReg, R_sum
  ungrouped, q = 1; (c) BT, R_off with ``use_kernel`` (the fused kernel) —
  on the port's kernel route (kernel plain versions under the kernels'
  autograd rules) and its plain route, within 5e-4 relative at every step.
* Twins of ``tests/test_checkpoint.py`` and ``tests/test_loop_ft.py``.
* The training CLI on the CPU.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import SSLDataConfig as RefDataConfig  # noqa: E402
from repro.data import ssl_batch as ref_ssl_batch  # noqa: E402
from repro.decorr import DecorrConfig as RefDecorrConfig  # noqa: E402
from repro.optim import lars as ref_lars  # noqa: E402
from repro.optim import warmup_cosine as ref_warmup_cosine  # noqa: E402
from repro.train.ssl import SSLModelConfig as RefModelConfig  # noqa: E402
from repro.train.ssl import init_ssl_params  # noqa: E402
from repro.train.ssl import make_ssl_train_step as ref_make_step  # noqa: E402
from repro.train.train_state import create_train_state as ref_create_state  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    AsyncCheckpointer,
    CheckpointManager,
    latest_step,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.data import SSLDataConfig, ssl_batch  # noqa: E402
from repro_torch.decorr import DecorrConfig  # noqa: E402
from repro_torch.ft import PreemptionSignal, StragglerWatchdog, with_retries  # noqa: E402
from repro_torch.optim import lars, warmup_cosine  # noqa: E402
from repro_torch.train import (  # noqa: E402
    LoopConfig,
    SSLModelConfig,
    create_train_state,
    init_ssl_model,
    make_ssl_train_step,
    params_from_jax,
    run_training,
)

STEPS = 20
RTOL = 5e-4
WIDTHS = dict(input_dim=256, backbone_widths=(128,), projector_widths=(256, 256))
ARMS = {
    "a-bt-rsum-b128-q2": dict(style="bt", reg="sum", block_size=128, q=2),
    "b-vic-rsum-ungrouped-q1": dict(style="vic", reg="sum", block_size=None, q=1),
    "c-bt-roff-kernel": dict(style="bt", reg="off", use_kernel=True),
}


def _data():
    return SSLDataConfig(input_dim=256, batch=128)


@functools.lru_cache(maxsize=None)
def _batches(n=STEPS):
    return [ssl_batch(_data(), s) for s in range(n)]


def _ref_perm(step, d=256):
    return torch.from_numpy(np.array(jax.random.permutation(jax.random.fold_in(jax.random.PRNGKey(0), step), d)))


@functools.lru_cache(maxsize=None)
def _ref_params():
    return jax.tree_util.tree_map(np.asarray, init_ssl_params(jax.random.PRNGKey(0), RefModelConfig(**WIDTHS)))


@functools.lru_cache(maxsize=None)
def _ref_curve(arm):
    cfg = RefModelConfig(**WIDTHS)
    opt = ref_lars(weight_decay=1e-4)
    state = ref_create_state(jax.tree_util.tree_map(jnp.asarray, _ref_params()), opt)
    step = jax.jit(ref_make_step(cfg, RefDecorrConfig(**ARMS[arm]), opt, ref_warmup_cosine(0.2, 2, STEPS))[0])
    losses = []
    for v1, v2 in _batches():
        state, m = step(state, {"view1": jnp.asarray(v1), "view2": jnp.asarray(v2)})
        losses.append(float(m[f"{ARMS[arm]['style']}_loss"]))
    return np.array(losses)


def test_ssl_batch_is_bit_identical_to_reference():
    for cfg, step in ((_data(), 0), (_data(), 7), (SSLDataConfig(input_dim=48, latent_dim=8, batch=5, seed=3), 2)):
        ref_cfg = RefDataConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
        for got, want in zip(ssl_batch(cfg, step), ref_ssl_batch(ref_cfg, step)):
            assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("arm", list(ARMS))
def test_twenty_step_loss_curve_matches_reference(arm, impl):
    want = _ref_curve(arm)
    model_cfg = SSLModelConfig(**WIDTHS)
    opt = lars(weight_decay=1e-4)
    state = create_train_state(params_from_jax(_ref_params(), model_cfg, device="cpu"), opt)
    step, _ = make_ssl_train_step(
        model_cfg, DecorrConfig(**ARMS[arm]), opt, warmup_cosine(0.2, 2, STEPS), perm_fn=_ref_perm, impl=impl
    )
    got = []
    for v1, v2 in _batches():
        state, m = step(state, {"view1": torch.from_numpy(v1), "view2": torch.from_numpy(v2)})
        got.append(float(m[f"{ARMS[arm]['style']}_loss"]))
    assert state.step == STEPS
    np.testing.assert_allclose(np.array(got), want, rtol=RTOL)


def test_fault_in_the_backward_pass_leaves_the_state_untouched():
    """A step that fails after the forward pass changes nothing, so a retry
    replays it exactly."""
    model_cfg = SSLModelConfig(**WIDTHS)
    opt = lars()
    state = create_train_state(init_ssl_model(model_cfg, seed=1), opt)
    step, _ = make_ssl_train_step(model_cfg, DecorrConfig(block_size=128), opt, lambda s: 0.1)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    v1, v2 = _batches()[0]
    batch = {"view1": torch.from_numpy(v1), "view2": torch.from_numpy(v2)}

    def fail(grad):
        raise RuntimeError("device fault in backward")

    handle = state.model.projector[-1].weight.register_hook(fail)
    with pytest.raises(RuntimeError, match="backward"):
        step(state, batch)
    handle.remove()
    assert state.step == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(torch.count_nonzero(s["mu"]) == 0 for s in state.opt_state.state.values())


# ---------------------------------------------------------------------------
# checkpoints (twins of tests/test_checkpoint.py)
# ---------------------------------------------------------------------------


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(4, 6, generator=g), "emb": torch.randn(8, 4, generator=g).to(torch.bfloat16)},
        "step": 7,
        "nested": [{"m": torch.ones(3)}, (torch.arange(5), 0.5, None, "lars")],
        "opt": {"state": {0: {"mu": torch.zeros(2)}}, "param_groups": [{"lr": 0.1, "params": [0]}]},
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_checkpoint_roundtrip_bf16_and_scalars(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path), 7, state)
    restored = restore_checkpoint(str(tmp_path), 7, state)
    for a, b in zip(_leaves(state), _leaves(restored)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        else:
            assert a == b
    assert isinstance(restored["nested"][1], tuple) and 0 in restored["opt"]["state"]


def test_uncommitted_checkpoint_ignored_and_collected(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path), 5, state)
    d = save_checkpoint(str(tmp_path), 10, state)
    os.remove(os.path.join(d, "COMMIT"))  # a torn write
    os.makedirs(tmp_path / "step_12.tmp")
    assert latest_step(str(tmp_path)) == 5
    CheckpointManager(str(tmp_path), use_async=False)
    assert sorted(os.listdir(tmp_path)) == ["step_5"]


@pytest.mark.parametrize("use_async", [False, True], ids=["sync", "async"])
def test_manager_keeps_the_newest_n(tmp_path, use_async):
    mgr = CheckpointManager(str(tmp_path), interval=1, keep=2, use_async=use_async)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state())
        mgr.wait()
    assert list_steps(str(tmp_path)) == [3, 4]


def test_manager_restore_latest_and_empty_dir(tmp_path):
    mgr = CheckpointManager(str(tmp_path), interval=1, keep=3, use_async=False)
    assert mgr.restore_latest(_state()) == (None, 0)
    state = _state()
    mgr.save(3, state)
    restored, step = mgr.restore_latest(_state(seed=1))
    assert step == 3 and torch.equal(restored["params"]["w"], state["params"]["w"])


def test_async_checkpointer_is_ordered_and_snapshots_before_returning(tmp_path):
    mgr = CheckpointManager(str(tmp_path), interval=1, keep=10, use_async=True)
    state = _state()
    for s in range(1, 6):
        state["params"]["w"].fill_(float(s))  # in place, as the optimizer does
        mgr.save(s, state)
    mgr.wait()
    assert list_steps(str(tmp_path)) == [1, 2, 3, 4, 5]
    for s in range(1, 6):
        restored = restore_checkpoint(str(tmp_path), s, state)
        assert torch.all(restored["params"]["w"] == float(s)), s


def test_async_save_surfaces_errors(tmp_path):
    ck = AsyncCheckpointer()
    ck.save(str(tmp_path), 1, {"bad": object()})
    with pytest.raises(TypeError):
        ck.wait()


# ---------------------------------------------------------------------------
# the loop (twins of tests/test_loop_ft.py)
# ---------------------------------------------------------------------------


def _setup():
    model_cfg = SSLModelConfig(**WIDTHS)
    opt = lars(weight_decay=1e-4)
    step_fn, _ = make_ssl_train_step(model_cfg, DecorrConfig(block_size=128), opt, warmup_cosine(0.2, 2, 50))
    batches = _batches(8)

    def batch_fn(step):
        v1, v2 = batches[step]
        return {"view1": torch.from_numpy(v1), "view2": torch.from_numpy(v2)}

    def fresh():
        return create_train_state(init_ssl_model(model_cfg, seed=0), opt)

    return step_fn, batch_fn, fresh


def _same_params(a, b):
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k


def test_transient_fault_retried(tmp_path):
    step_fn, batch_fn, fresh = _setup()
    calls = {"faults": 0}

    def fault_hook(step):
        if step == 3 and calls["faults"] < 2:
            calls["faults"] += 1
            raise RuntimeError("flaky device")

    cfg = LoopConfig(total_steps=5, ckpt_dir=str(tmp_path), ckpt_interval=100, max_step_retries=3)
    state = run_training(fresh(), step_fn, batch_fn, cfg, fault_hook=fault_hook)
    assert state.step == 5 and calls["faults"] == 2


def test_unrecoverable_fault_raises(tmp_path):
    step_fn, batch_fn, fresh = _setup()

    def fault_hook(step):
        if step == 2:
            raise RuntimeError("dead host")

    with pytest.raises(RuntimeError, match="dead host"):
        run_training(fresh(), step_fn, batch_fn, LoopConfig(total_steps=5, ckpt_dir=str(tmp_path), max_step_retries=1),
                     fault_hook=fault_hook)


@pytest.mark.parametrize("how", ["clean-stop", "crash"])
def test_kill_and_resume_equals_uninterrupted(tmp_path, how):
    """Deterministic data keyed by step, the checkpointed optimizer state and
    the permutation seed: a restart lands on the same params."""
    step_fn, batch_fn, fresh = _setup()
    ref = run_training(fresh(), step_fn, batch_fn, LoopConfig(total_steps=8))
    d = str(tmp_path / "ckpt")
    if how == "clean-stop":
        run_training(fresh(), step_fn, batch_fn, LoopConfig(total_steps=4, ckpt_dir=d, ckpt_interval=2))
    else:
        def die(step):
            if step == 5:
                raise RuntimeError("killed")

        with pytest.raises(RuntimeError):
            run_training(fresh(), step_fn, batch_fn, LoopConfig(total_steps=8, ckpt_dir=d, ckpt_interval=2,
                                                                max_step_retries=0), fault_hook=die)
        assert latest_step(d) == 4
    resumed = run_training(fresh(), step_fn, batch_fn, LoopConfig(total_steps=8, ckpt_dir=d, ckpt_interval=2))
    assert resumed.step == 8
    _same_params(ref, resumed)


def test_preemption_checkpoints_and_exits(tmp_path):
    step_fn, batch_fn, fresh = _setup()
    flag = str(tmp_path / "PREEMPT")
    PreemptionSignal(flag).set()
    cfg = LoopConfig(total_steps=100, ckpt_dir=str(tmp_path / "ck"), ckpt_interval=1000, preempt_flag=flag)
    state = run_training(fresh(), step_fn, batch_fn, cfg)
    assert state.step == 1 and latest_step(str(tmp_path / "ck")) == 1


def test_telemetry_hooks_are_refused_not_ignored():
    step_fn, batch_fn, fresh = _setup()
    for hook in ("registry", "monitor", "perf"):
        with pytest.raises(NotImplementedError, match="observability"):
            run_training(fresh(), step_fn, batch_fn, LoopConfig(total_steps=1), **{hook: object()})


def test_straggler_watchdog_flags_outliers():
    import time

    wd = StragglerWatchdog(window=16, factor=3.0, min_samples=4)
    for _ in range(6):
        wd.step_start()
        time.sleep(0.002)
        wd.step_end()
    wd.step_start()
    time.sleep(0.05)
    assert wd.step_end() is True
    assert wd.straggler_events == 1


def test_with_retries_backoff():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("boom")
        return 42

    assert with_retries(flaky, max_retries=5, backoff_s=0.001)() == 42
    assert calls["n"] == 3


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_tiny_on_cpu_trains_checkpoints_and_reports_eq16(tmp_path, capsys):
    from repro_torch.train import cli

    argv = ["--tiny", "--device", "cpu", "--steps", "6", "--ckpt-dir", str(tmp_path)]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "final step=6" in out and "normalized R_off (Eq.16)" in out
    assert latest_step(str(tmp_path)) == 6


@pytest.mark.parametrize("flag", [["--distributed", "global"], ["--pretune", "analytic"]])
def test_cli_refuses_later_slices(flag):
    from repro_torch.train import cli

    with pytest.raises(NotImplementedError, match="not ported yet"):
        cli.main(["--tiny", "--device", "cpu", *flag])
