"""Fixtures of the benchmark's CPU tests: a copy of the benchmark cut to
sizes a test run can hold (every width small, the same files otherwise)."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SMALL_CONFIGS = {
    "ssl-paper-d8192": dict(input_dim=48, backbone_widths=[32, 32], projector_widths=[64, 64, 64]),
    "rwkv6-3b": dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256, rwkv_head_dim=16, rwkv_chunk=8,
                     compute_dtype="float32"),
}
SMALL_TRAFFIC = {"ssl_train": dict(batch=16, pool=4), "lm_train": dict(batch=2, seq=32, pool=4, trace_calls=2)}
# The cells' limits hold the readings of the timed sizes on the card.  At
# these sizes, on the CPU, float32 rounding reads up to 1.5e-7 in the loss,
# 1e-6 in the change and 7.3e-7 in grad_gap; the control reads 3.6e-5 or
# more in the loss, 7e-4 or more in grad_gap and 2.2e-3 or more in the
# change.
SMALL_LIMITS = {"loss_rel": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-4}


def make_small_root(dest: Path) -> Path:
    """A checkout-like directory: BENCHMARK.json and a copy of ``bench/``
    with every configuration and traffic mix cut to test sizes, and every
    cell's limits set to the test sizes' (``SMALL_LIMITS``)."""
    shutil.copytree(REPO / "bench", dest / "bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(SMALL_CONFIGS[c["name"]])
        path.write_text(json.dumps(cfg))
    for path in (dest / "bench" / "limits").glob("*.json"):
        path.write_text(json.dumps(SMALL_LIMITS))
    for path in (dest / "bench" / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr.update(SMALL_TRAFFIC[tr["driver"]])
        if tr.get("loss", {}).get("block_size"):
            tr["loss"]["block_size"] = 16
        path.write_text(json.dumps(tr))
    return dest


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    return make_small_root(tmp_path_factory.mktemp("bench_small"))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: six test workers share the cores."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
