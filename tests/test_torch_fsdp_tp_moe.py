"""The port's 2-D LM train step for the MoE and recurrent archs on the CPU:
FSDP over ``data``, TP and the MoE experts over ``model``, the batch over
``("pod", "data")`` (``models/moe`` expert parallelism, ``models/ssm``'s
Mamba channels and RWKV6 heads over ``model``).

The jobs are ``tests/test_torch_fsdp_tp.py``'s (``run_jobs`` on this
file's ``CASES``), started at once by one module fixture: a 4-rank gloo job
of the port a mesh, each placing the reference's weights and taking 2 AdamW
steps of 2 microbatches, the decorrelation aux on, and one reference
subprocess a case (its one-device step, ordered as the ranks'
microbatches, and its GSPMD step on one mesh, 4 fake XLA devices):

* llama4-scout (16 experts top-1 and a shared expert; reduced: 4), arctic
  (top-2 and a dense residual MLP) and jamba (Mamba, attention, dense and
  MoE layers), rwkv6-3b reduced, on (data 2, model 2) and (data 1, model 4),
  arctic also on (pod 2, data 1, model 2); and rwkv6 with
  ``rwkv_head_dim=32`` on (data 1, model 4), whose 2 heads do not split over
  4 ranks (every head computed whole on each rank);
* loss terms and the clip's norm within 5e-4 relative, each step's
  gradients and the gathered parameters within 5e-4 of each leaf's
  largest entry, against the reference's one-device step; one case an arch
  against the reference's GSPMD step; every rank's blocks of ``launch/specs``'
  local shapes;
* the unplaced data-parallel step of reduced llama4-scout with the batch
  over ``("pod", "data")`` on (pod 2, data 2): the ungrouped MoE dispatch
  seats each claim by the claim counts of every batch rank in row-major
  order (``models/moe._global_offsets``), against the one-device step.

AdamW runs at eps 1e-8 for arctic and at 1e-3 for the other cases
(``EPS``; see ``tests/test_torch_fsdp_tp.py``'s ``EPS``), which failed at
1e-8, each on its first check to fail: llama4 on (data 1, model 4), the
embedding 2.2e-2 of its largest apart after 2 steps (an lr step); jamba on
(data 2, model 2), step 1's router gradient 6.1e-4 apart, on (data 1,
model 4) step 1's ``dt_proj`` gradient 5.8e-4 and, against GSPMD, the
first norm 5.4e-4; rwkv6 on (data 2, model 2), step 1's clip norm 7.5e-4
relative (1.2e-3 against GSPMD), on (data 1, model 4) step 1's embedding
gradient 1.1e-3; rwkv6 with ``rwkv_head_dim=32``, the embedding 2.4e-3
apart after 2 steps.  None fails at step 0: the first steps are
sign-like at 1e-8, so an entry whose gradient is rounding moves by up to
lr either way and the next step's gradients part.
"""

import pytest

torch = pytest.importorskip("torch")

import test_torch_fsdp_tp as base  # noqa: E402
from test_torch_fsdp_tp import _one_torch_thread  # noqa: E402,F401  (autouse: one intra-op thread)

ARCHS = ["llama4-scout-17b-a16e", "arctic-480b", "jamba-v0.1-52b", "rwkv6-3b"]
RWKV_WHOLE_HEADS = "rwkv6-3b:hd32"
VARIANTS = {arch: (arch, {}) for arch in ARCHS}
VARIANTS[RWKV_WHOLE_HEADS] = ("rwkv6-3b", {"rwkv_head_dim": 32})
MESHES = {"a": [2, 2], "b": [1, 4], "c": [2, 1, 2], "p": [2, 2]}
RUNS = {"a": ARCHS, "b": ARCHS + [RWKV_WHOLE_HEADS], "c": ["arctic-480b"]}
# AdamW's eps a case: 1e-3 where 1e-8 failed (the module note)
EPS = {"*": 1e-3, "arctic-480b": 1e-8}
GSPMD = {"llama4-scout-17b-a16e": "a", "arctic-480b": "c", "jamba-v0.1-52b": "b", "rwkv6-3b": "a"}
CASES = dict(base.CASES, variants=VARIANTS, runs=RUNS, meshes=MESHES, gspmd=GSPMD, eps=EPS,
             axes={"p": ["pod", "data"]}, dp={"mesh": "p", "case": "llama4-scout-17b-a16e"}, ce_cross=None)

CELLS = base.cells(CASES)
IDS = [base.cell_id(a, m, CASES) for a, m in CELLS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return base.run_jobs(str(tmp_path_factory.mktemp("fsdp_tp_moe")), CASES)


@pytest.mark.parametrize("arch,mesh", CELLS, ids=IDS)
def test_placed_step_matches_the_one_device_step(runs, arch, mesh):
    base.check_one_device(runs, arch, mesh, CASES)


@pytest.mark.parametrize("arch,mesh", list(GSPMD.items()), ids=[base.cell_id(a, m, CASES) for a, m in GSPMD.items()])
def test_placed_step_matches_the_references_gspmd_step(runs, arch, mesh):
    base.check_gspmd(runs, arch, mesh, CASES)


@pytest.mark.parametrize("arch,mesh", CELLS, ids=IDS)
def test_each_rank_holds_only_its_blocks(runs, arch, mesh):
    base.check_blocks(runs, arch, mesh, CASES)


def test_data_parallel_moe_dispatch_over_pod_and_data(runs):
    """The unplaced step, llama4's ungrouped dispatch over ("pod", "data"), equals the oracle."""
    base.check_dp(runs, CASES)
