"""Import hygiene: every ``repro_torch`` module, and ``chip_smoke.py``,
imports neither JAX nor anything of the reference package ``repro``."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

CHECK = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names), bad, " ".join(names))
assert not bad, bad
"""

# the numpy-only serving modules the port keeps its own copies of, the
# model families and arch configs of the LM serving path, the modules of
# the LM training path, those of distributed training / serving and
# telemetry, the fabric and the tuner, the launch analysis tools, and the
# 2-D train step's layout
COPIES = ("repro_torch.data.synthetic", "repro_torch.core.decorrelation", "repro_torch.core.whitening",
          "repro_torch.train.step", "repro_torch.launch.train",
          "repro_torch.serve.sampling", "repro_torch.serve.spec", "repro_torch.serve.paging.radix",
          "repro_torch.serve.paging.allocator", "repro_torch.serve.slots",
          "repro_torch.models.moe", "repro_torch.models.ssm", "repro_torch.configs.jamba_v01_52b",
          "repro_torch.configs.rwkv6_3b", "repro_torch.configs.musicgen_large", "repro_torch.configs.qwen2_vl_2b",
          # distributed training and serving, telemetry
          "repro_torch.data.pipeline", "repro_torch.ft.elastic", "repro_torch.obs", "repro_torch.obs.registry",
          "repro_torch.obs.recorder", "repro_torch.obs.tracing", "repro_torch.obs.alerts", "repro_torch.obs.http",
          "repro_torch.obs.profiling", "repro_torch.obs.perf", "repro_torch.obs.health", "repro_torch.obs.context",
          "repro_torch.launch.obs_args",
          # the serving fabric, the serve launcher, the catalog and the tuner
          "repro_torch.serve.fabric", "repro_torch.serve.fabric.router", "repro_torch.serve.fabric.failover",
          "repro_torch.serve.fabric.replica", "repro_torch.launch.serve", "repro_torch.obs.catalog",
          "repro_torch.tune.cache", "repro_torch.tune.dispatch", "repro_torch.tune.tuner", "repro_torch.tune.cli",
          "repro_torch.tune.__main__", "repro_torch.decorr.warmup",
          # the launch analysis tools
          "repro_torch.launch.hlo_cost", "repro_torch.launch.specs", "repro_torch.launch.dryrun",
          "repro_torch.launch.perf",
          # the 2-D (FSDP x TP) train step's placement and collectives
          "repro_torch.parallel.fsdp_tp")

SMOKE = r"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
sys.path.insert(0, sys.argv[2])
import repro_torch.serve.engine, repro_torch.serve.service, repro_torch.serve.loadgen
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
assert not bad, bad
print("ok")
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", CHECK], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 30  # the package, its subpackages and modules
    names = set(out.stdout.split("]", 1)[1].split())
    missing = [m for m in COPIES if m not in names]
    assert not missing, missing


def test_chip_smoke_imports_no_jax_and_nothing_of_repro():
    """``chip_smoke.py`` as a module (its imports, no ``main``) plus the
    serving modules its LM phase drives load no JAX and nothing of repro."""
    root = os.path.dirname(SRC)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", SMOKE, os.path.join(root, "chip_smoke.py"), SRC], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
