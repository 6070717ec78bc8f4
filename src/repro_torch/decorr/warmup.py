"""Tune-cache warm-up for the decorrelation kernels (port of
``repro/decorr/warmup.py``).

``warmup_tune_cache`` pre-tunes every choice one regularizer call can reach
— forward and backward — for the SHARD-LOCAL shapes the engine will
dispatch under the given mesh and mode:

  * ``local`` / ``global``: rows = n / data_parallel, width = d (batch
    sharded, features full);
  * ``tp``: rows = n / (data_parallel * model_parallel), width = d (the
    regularizer runs on the all-to-all-transposed full-feature rows, of
    which each model shard holds a 1/P slice of the local batch).

Called at launcher start-up (``launch/train.py``, ``train/cli.py``) before
the first step, so no search lands inside it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.decorr.config import DecorrConfig


def shard_local_shape(
    n: int,
    d: int,
    cfg: DecorrConfig,
    *,
    data_parallel: int = 1,
    model_parallel: int = 1,
) -> Tuple[int, int]:
    """(rows, width) of the arrays the regularizer kernels see per shard."""
    rows = max(n // max(data_parallel, 1), 1)
    if cfg.distributed == "tp":
        rows = max(rows // max(model_parallel, 1), 1)
    return rows, d


def mesh_parallelism(mesh, data_axis: str = "data", model_axis: str = "model") -> Tuple[int, int]:
    """(data_parallel, model_parallel) sizes of a ``DeviceMesh`` (1 for
    absent axes, and for no mesh)."""
    if mesh is None:
        return 1, 1
    shape = dict(zip(mesh.mesh_dim_names or (), mesh.shape))
    return int(shape.get(data_axis, 1)), int(shape.get(model_axis, 1))


def warmup_tune_cache(
    n: int,
    d: int,
    cfg: DecorrConfig,
    *,
    mesh=None,
    data_parallel: Optional[int] = None,
    model_parallel: Optional[int] = None,
    mode: str = "analytic",
    persist: bool = False,
    verbose: bool = False,
    device=None,
) -> List:
    """Pre-tune the decorrelation choices for the shard-local shapes.

    ``mode``: 'analytic' (instant, the launchers' default), 'dry' (counted
    FLOPs) or 'measure' (timed on ``device``: ``cuda`` unless ``"cpu"`` is
    passed).  ``persist=True`` also writes the winners to the JSON cache so
    the next process starts warm.  Returns the TuneResults.
    """
    from repro_torch import tune
    from repro_torch.tune.cli import jobs_for

    dp, mp = mesh_parallelism(mesh)
    dp = data_parallel if data_parallel is not None else dp
    mp = model_parallel if model_parallel is not None else mp
    rows, width = shard_local_shape(n, d, cfg, data_parallel=dp, model_parallel=mp)

    tune_kw = dict(mode=mode, persist=persist, device=device)
    plans, jobs = jobs_for(rows, width, block_size=cfg.block_size, **tune_kw)
    results = list(plans)
    for kernel, shape in jobs:
        results.append(tune.tune(kernel, shape, **tune_kw))
    if verbose:
        for r in results:
            moved = "tuned" if r.best != r.default else "kept default"
            print(f"[decorr.warmup] {r.kernel} {'x'.join(map(str, r.shape))}: {moved} {r.best}")
    return results
