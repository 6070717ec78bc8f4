"""What the benchmark's files may import and read, and its counts against
hand-worked values."""

import ast
import math
from pathlib import Path

import pytest

from bench.counts import decorr_loss, lm, peaks, ssl

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
JAX_FOLDER = "bench" + "marks"  # the JAX package's benchmark folder, spelt so this file does not name it


def _imports(path: Path):
    """Top-level names of every module ``path`` imports (whole names)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_and_no_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN
    assert JAX_FOLDER not in set(_imports(path)) and f"{JAX_FOLDER}/" not in path.read_text()


def test_top_level_names_compare_whole():
    # the port's name begins with the JAX package's: compared whole, it is not it
    assert "repro_torch".split(".", 1)[0] not in FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_system(path):
    assert "repro_torch" not in set(_imports(path))
    assert "repro_torch" not in path.read_text()


def test_ssl_model_flops():
    cfg = {"input_dim": 3072, "backbone_widths": [512, 512], "projector_widths": [8192] * 3}
    params = 3072 * 512 + 512 * 512 + 512 * 8192 + 2 * 8192 * 8192
    assert ssl.gemm_params(cfg) == params == 140_247_040
    assert ssl.step_flops(cfg, 256) == 6 * params * 512
    assert math.isclose(ssl.step_flops(cfg, 256), 4.31e11, rel_tol=1e-3)


def test_lm_model_flops():
    cfg = {"n_layers": 32, "d_model": 2560, "d_ff": 8960, "vocab_size": 65536}
    d = 2560
    layer = 6 * d * d + 2 * d * 8960 + 2 * d * 160 + 2 * d * 32
    assert lm.matmul_params(cfg) == 32 * layer + d * 65536
    assert math.isclose(lm.step_flops(cfg, 4, 4096), 6 * lm.matmul_params(cfg) * 16384)
    assert math.isclose(lm.step_flops(cfg, 4, 4096), 2.876e14, rel_tol=1e-3)


def test_loss_bounds():
    n, d = 256, 8192
    roff = {"style": "bt", "reg": "off"}
    assert decorr_loss.loss_flops(n, d, roff) == 3 * 2 * 256 * 8192**2
    assert math.isclose(decorr_loss.loss_bound_s(n, d, roff), 3 * 2 * 256 * 8192**2 / 67e12)
    assert decorr_loss.loss_bytes(n, d) == 4 * 256 * 8192 * 4
    grouped = {"style": "bt", "reg": "sum", "block_size": 128, "q": 2}
    fft = 2 * 256 * 64 * 2.5 * 128 * 7
    products = 8 * 256 * 64 * 64 * 65
    assert math.isclose(decorr_loss.loss_flops(n, d, grouped), 3 * (fft + products))
    vic = {"style": "vic", "reg": "sum", "block_size": None, "q": 1}
    fwd = 2 * 256 * 2.5 * 8192 * 13 + 8 * 256 * 4097 + 2.5 * 8192 * 13
    assert math.isclose(decorr_loss.loss_flops(n, d, vic), 3 * 2 * fwd)
    for loss in (roff, grouped, vic):
        bound = max(decorr_loss.loss_flops(n, d, loss) / peaks.F32_FLOPS, decorr_loss.loss_bytes(n, d) / peaks.HBM_BYTES_PER_S)
        assert decorr_loss.loss_bound_s(n, d, loss) == bound
    # the FFT-relaxed losses need a fiftieth of R_off's least time or less
    assert decorr_loss.loss_bound_s(n, d, grouped) < decorr_loss.loss_bound_s(n, d, roff) / 50
