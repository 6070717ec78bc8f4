"""The benchmark's correctness check on the CPU at small sizes: the plain
reference against the system, its control, and faults planted under the
timed path."""

import dataclasses
import statistics

import pytest
import torch

from bench.benchlib import compare, faults, harness, spec
from bench.reference import decorr, numerics, rwkv6

SSL_CELLS = ["ssl_bt_rsum_b128_d8192", "ssl_bt_roff_d8192", "ssl_vic_rsum_q1_d8192"]
LM_CELL = "lm_train_rwkv6_3b_s4096"
CELLS = SSL_CELLS + [LM_CELL]
SEED = 2**31 + 77  # past 32 signed bits, as the driver's seeds are


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_run_is_correct_and_reports_its_metrics(small_root, workload, trace):
    out = harness.run_cell(workload, SEED, 0.05, trace, root=small_root, device="cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    c = spec.cell(small_root, workload)
    assert set(out["checks"]) == set(c.limits)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    got = set(out["metrics"])
    assert got <= want
    if not trace:
        assert got == want
    else:
        assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
        assert all(n > 0 for n in out["kernel_launches"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_cells_limits(small_root, workload):
    """The reference at the precision below the configuration's, in the
    system's place, is not correct under the cell's limits."""
    c = spec.cell(small_root, workload)
    if c.traffic["driver"] == "lm_train":
        c = dataclasses.replace(c, config=dict(c.config, compute_dtype="bfloat16"))
        control = "fp8"
    else:
        control = "tf32"
    drv = spec.driver(c)
    ref = drv.reference(c, SEED, torch.device("cpu"), "fp32")
    ctl = drv.reference(c, SEED, torch.device("cpu"), control)
    assert not compare.passed(compare.judge(compare.numbers(ctl, ref), c.limits))


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_fault_under_the_timed_path_is_not_correct(small_root, workload, fault):
    c = spec.cell(small_root, workload)
    with faults.planted(c.traffic["driver"], fault):
        out = harness.run_cell(workload, SEED, 0.05, False, root=small_root, device="cpu")
    assert not out["correct"]


@pytest.mark.parametrize("workload", SSL_CELLS)
def test_first_gradient_is_the_one_the_optimizer_takes(small_root, workload):
    """The compared first gradient is the raw gradient the update took,
    on both sides, not LARS's trust-scaled momentum."""
    c = spec.cell(small_root, workload)
    drv = spec.driver(c)
    sess = drv.setup(c, SEED, torch.device("cpu"))
    prog = sess.readings
    sess.close()
    ref = drv.reference(c, SEED, torch.device("cpu"), "fp32")
    assert ref["first_grads"] == ref["grads"]
    # a leaf whose gradient is nought to rounding (the last projector bias
    # under the batch's centring) is held against the median leaf
    floor = 1e-5 * statistics.median(ref["grads"].values())
    for leaf, norm in ref["grads"].items():
        assert prog["first_grads"][leaf] == pytest.approx(norm, rel=1e-5, abs=floor)


def test_chunked_wkv_equals_the_step_by_step_recurrence():
    gen = torch.Generator().manual_seed(3)
    b, s, h, hd = 2, 48, 3, 8
    r, k, v = (torch.randn((b, s, h, hd), generator=gen) for _ in range(3))
    logw = -torch.exp(torch.randn((b, s, h, hd), generator=gen) - 3)
    u = 0.1 * torch.randn((h, hd), generator=gen)
    want = rwkv6.wkv_scan(r, k, v, logw, u)
    got = rwkv6.wkv_chunked(r, k, v, logw, u, 16, numerics.rounder("fp32"))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("block", [None, 4])
def test_regularizer_from_the_matrix_equals_the_systems(q, block):
    from repro_torch.core import regularizers as regs

    gen = torch.Generator().manual_seed(q + (block or 0))
    z1, z2 = torch.randn((10, 12), generator=gen), torch.randn((10, 12), generator=gen)
    c = decorr.correlation(z1, z2, 10.0)
    want = regs.r_sum_auto(z1, z2, q=q, block_size=block, scale=10.0, impl="plain")
    torch.testing.assert_close(decorr.r_sum(c, q, block), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(decorr.r_off(c), regs.r_off(regs.cross_correlation_matrix(z1, z2, 10.0)))


def test_controls_round_to_their_precision():
    x = torch.tensor([1.0 + 2.0**-12, 3.0, -0.1])
    assert numerics.round_tf32(x)[0] == 1.0
    assert numerics.round_fp8(torch.tensor([1.0, 448.0, 1.06]))[2] == 1.0
    rnd = numerics.rounder("tf32")
    y = x.clone().requires_grad_(True)
    (rnd(y) * 2).sum().backward()
    assert torch.equal(y.grad, torch.full_like(x, 2.0))
