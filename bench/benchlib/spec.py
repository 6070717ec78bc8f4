"""What ``BENCHMARK.json`` and the data files beside the harness say about a cell.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Each is found by its name, in files of its own:

* the configuration: the ``file`` its ``configs`` entry gives (JSON);
* the traffic mix: ``<bench>/traffic/<traffic>.json``, whose ``driver``
  names the entry the window drives, ``<bench>/drivers/<driver>.py``;
* the limits of the cell's correctness check: ``<bench>/limits/<cell>.json``;
* each metric's reader: ``<bench>/metrics/<metric>.py``, a ``read(record)``
  that returns the metric's value or None.

``<bench>`` is the first of ``paths``.  Adding a configuration, a mix, a
cell or a metric is adding such files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One cell with everything its files hold."""

    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    bench_dir: Path


def load_benchmark(root: Path) -> Dict:
    with open(Path(root) / "BENCHMARK.json") as fh:
        return json.load(fh)


def applies(metric: Dict, cell: str) -> bool:
    """A metric is reported in the cells its ``workloads`` lists, or in every cell without one."""
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of the benchmark at ``root``."""
    root = Path(root)
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the benchmark has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    bench_dir = root / bench["paths"][0]
    for name in (w["name"], w["config"], w["traffic"]):
        if not NAME.match(name):
            raise ValueError(f"not a valid name: {name!r}")
    return Cell(
        name=w["name"],
        config_name=w["config"],
        traffic_name=w["traffic"],
        chips=int(w["chips"]),
        config=_json(root / configs[w["config"]]["file"]),
        traffic=_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=_json(bench_dir / "limits" / f"{w['name']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, w["name"])],
        per_layer=[m for m in bench["per_layer"] if applies(m, w["name"])],
        bench_dir=bench_dir,
    )


def load_module(path: Path, name: str):
    """The module in file ``path``, under the module name ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def _key(path: Path) -> str:
    return "bench_file_" + re.sub(r"\W", "_", str(path.resolve()))


def driver(c: Cell):
    """The driver module of the cell's traffic mix."""
    path = c.bench_dir / "drivers" / f"{c.traffic['driver']}.py"
    return load_module(path, _key(path))


def reader(c: Cell, metric: str) -> Callable[[Dict], Optional[float]]:
    """The ``read`` function of metric ``metric``."""
    path = c.bench_dir / "metrics" / f"{metric}.py"
    return load_module(path, _key(path)).read
