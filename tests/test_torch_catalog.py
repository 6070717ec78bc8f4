"""The port's generated metrics page (``repro_torch.obs.catalog`` ->
``docs/metrics_torch.md``) against the reference's (``docs/metrics.md``,
which ``python -m repro.obs.catalog --check`` keeps current).

* Every metric row of the reference's page is on the port's page with the
  same type, labels, unit and alert-rule cell; every help text that
  differs is listed below with its reason, and so is every row the port
  has and the reference does not.
* The alert-rule tables are identical.
* ``python -m repro_torch.obs.catalog --check --device cpu`` passes on the
  committed page, whose default path is never the reference's.
"""

import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.obs import catalog  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PAGE = os.path.join(REPO, "docs", "metrics.md")
PORT_PAGE = os.path.join(REPO, "docs", "metrics_torch.md")

# help texts that differ, each for a reason
HELP_DIFFERS = {
    # the port has no AOT compile: an engine's first call of a shape is timed
    "exec_compile_seconds": ("AOT lower+compile wall time", "first-call (warmup) wall time"),
    # ... and its per-executable cache is a set of warmed shapes, not XLA's compile cache
    "exec_cache_hits_total": ("compile-cache hits", "shape-cache hits"),
    "exec_cache_misses_total": ("compile-cache misses", "shape-cache misses"),
}
# the port's probe returns the two outputs the reference's probe_metrics
# documents and drops (ROADMAP queue 3, "Conditions"); each gets a gauge and
# its EMA, on the serve probe and the train health monitor
PORT_ONLY = {f"{p}decorr_{k}{e}" for p in ("", "train_") for k in ("mean_abs", "std_err") for e in ("", "_ema")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (see tests/test_torch_lm_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cells(line):
    return [c.strip() for c in line.strip().strip("|").split("|")]


def _page(path):
    """({metric: (type, labels, unit, rules, help)}, [alert-rule rows], footer)."""
    with open(path) as f:
        lines = f.read().splitlines()
    metrics, rules, section = {}, [], None
    for line in lines:
        if line.startswith("## "):
            section = line[3:].strip()
        elif line.startswith("| `"):
            cells = _cells(line)
            if section == "Metrics":
                metrics[cells[0].strip("`")] = tuple(cells[1:])
            else:
                rules.append(tuple(cells))
    footer = next(line for line in lines if re.match(r"\d+ metric families", line))
    return metrics, rules, footer


def test_port_page_matches_the_reference_page_row_by_row():
    ref, ref_rules, _ = _page(REF_PAGE)
    port, port_rules, footer = _page(PORT_PAGE)
    assert len(ref) >= 150 and port_rules == ref_rules
    assert set(port) - set(ref) == PORT_ONLY
    assert not set(ref) - set(port), sorted(set(ref) - set(port))
    for name, (kind, labels, unit, rules, help_) in ref.items():
        p_kind, p_labels, p_unit, p_rules, p_help = port[name]
        assert (p_kind, p_labels, p_unit, p_rules) == (kind, labels, unit, rules), name
        if name in HELP_DIFFERS:
            assert (help_, p_help) == HELP_DIFFERS[name], name
        else:
            assert p_help == help_, name
    for name in PORT_ONLY:
        assert port[name][:4] == ("gauge", "", "value", ""), name
    assert footer.startswith(f"{len(port)} metric families")


def test_committed_page_is_current_and_default_path_is_the_ports():
    assert catalog.DEFAULT_OUT == "docs/metrics_torch.md"
    with open(PORT_PAGE) as f:
        assert f.read() == catalog.generate(device="cpu")
    assert catalog.GENERATED_BANNER.startswith("<!-- GENERATED by `PYTHONPATH=src python -m repro_torch.obs.catalog`")


def test_catalog_check_cli_passes_on_the_committed_page():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.catalog", "--check", "--device", "cpu"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "docs/metrics_torch.md is up to date" in out.stdout


def test_catalog_check_fails_on_a_stale_page(tmp_path, capsys):
    stale = tmp_path / "stale.md"
    stale.write_text("# not the page\n")
    assert catalog.main(["--check", "--device", "cpu", "--out", str(stale)]) == 1
    assert "STALE" in capsys.readouterr().out
    assert catalog.main(["--check", "--device", "cpu", "--out", str(tmp_path / "missing.md")]) == 1


def test_infer_unit_follows_the_name_suffixes():
    assert catalog.infer_unit("serve_ttft_seconds") == "seconds"
    assert catalog.infer_unit("paged_cache_bytes_peak") == "bytes"
    assert catalog.infer_unit("fabric_routed_total") == "count"
    assert catalog.infer_unit("slots_occupancy") == "ratio"
    assert catalog.infer_unit("decorr_r_sum_norm") == "value"
