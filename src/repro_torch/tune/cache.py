"""Persistent JSON cache of tuned configs (port of ``repro/tune/cache.py``).

One file per backend under the cache directory::

    <cache_dir>/<backend>.json
    {"schema": 1, "entries": {"<kernel>|<shape>|<dtype>": {"config": {...},
                                                           "source": "...",
                                                           "cost": {...}}}}

The directory is ``REPRO_TUNE_CACHE`` or ``~/.cache/repro-tune``, the
reference's own; the port's backend keys (``backend_key``:
``torch-cuda-sm<major><minor>``, ``torch-cpu``) never collide with the
reference's file names (``cpu``, ``tpu``).  A schema-version mismatch
invalidates the whole file, and every I/O failure degrades to a cache miss:
tuning never takes a training job down.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

SCHEMA_VERSION = 1

_ENV_VAR = "REPRO_TUNE_CACHE"


def backend_key(device=None) -> str:
    """``torch-cuda-sm<major><minor>`` for a CUDA device (the current one
    when ``device`` is None and CUDA is available), else ``torch-cpu``."""
    dev = torch.device(device) if device is not None else None
    if dev is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev is not None and dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        return f"torch-cuda-sm{major}{minor}"
    return "torch-cpu"


def cache_dir() -> Path:
    env = os.environ.get(_ENV_VAR)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro-tune"


def _backend_path(backend: str, directory: Optional[Path] = None) -> Path:
    return Path(directory or cache_dir()) / f"{backend}.json"


def entry_key(kernel: str, shape, dtype: str) -> str:
    return f"{kernel}|{'x'.join(str(int(s)) for s in shape)}|{dtype}"


def load_all(backend: str, directory: Optional[Path] = None) -> Dict[str, dict]:
    """All entries for a backend; {} on missing file, bad JSON, or schema skew."""
    try:
        with open(_backend_path(backend, directory)) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(data, dict) or data.get("schema") != SCHEMA_VERSION:
        return {}
    entries = data.get("entries")
    return entries if isinstance(entries, dict) else {}


def lookup(kernel: str, shape, dtype: str, backend: str, directory: Optional[Path] = None) -> Optional[dict]:
    """The cached entry ({"config", "source", "cost"}) or None."""
    entry = load_all(backend, directory).get(entry_key(kernel, shape, dtype))
    if isinstance(entry, dict) and isinstance(entry.get("config"), dict):
        return entry
    return None


@contextlib.contextmanager
def _file_lock(path: Path):
    """Best-effort exclusive flock on <path>.lock: serializes the
    read-modify-write across processes so concurrent tuner runs don't drop
    each other's entries.  Degrades to unlocked where flock is unavailable
    (the atomic rename still prevents torn files, just not lost updates)."""
    lf = None
    try:
        import fcntl

        lf = open(path.with_suffix(".lock"), "w")
        fcntl.flock(lf, fcntl.LOCK_EX)
    except (ImportError, OSError):
        if lf is not None:
            lf.close()
            lf = None
    try:
        yield
    finally:
        if lf is not None:
            try:
                lf.close()  # closing drops the flock
            except OSError:
                pass


def store(
    kernel: str,
    shape,
    dtype: str,
    backend: str,
    config: dict,
    source: str = "analytic",
    cost: Optional[dict] = None,
    directory: Optional[Path] = None,
) -> bool:
    """Locked read-modify-write of one entry (atomic rename).
    False if the file system said no."""
    path = _backend_path(backend, directory)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        with _file_lock(path):
            entries = load_all(backend, directory)
            entries[entry_key(kernel, shape, dtype)] = {
                "config": {k: int(v) for k, v in config.items()},
                "source": source,
                "cost": cost or {},
            }
            fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump({"schema": SCHEMA_VERSION, "entries": entries}, f, indent=1, sort_keys=True)
                os.replace(tmp, path)
            finally:
                # a failed write must not orphan the temp file (after a
                # successful replace the unlink is a no-op)
                with contextlib.suppress(OSError):
                    os.unlink(tmp)
        return True
    except OSError:
        return False
