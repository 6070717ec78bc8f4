"""Async, atomically committed checkpoints of nested state dicts (port of
``repro/checkpoint/checkpointer.py``).

A state is a tree of dicts, lists and tuples whose leaves are tensors or
plain scalars (int, float, bool, str, None) — what ``nn.Module.state_dict``
and ``torch.optim.Optimizer.state_dict`` return.  Layout::

    <dir>/step_<N>.tmp/            during write
    <dir>/step_<N>/                after the atomic rename
        manifest.json              leaf paths, dtypes, shapes; scalar leaves inline
        leaf_00000.bin ...         raw bytes of each tensor (bf16 included)
        COMMIT                     written last — its absence marks a torn write

A crash mid-save leaves a ``.tmp`` directory or one without COMMIT; both are
ignored by ``latest_step`` (and collected by ``CheckpointManager``).  Saving
is async on one worker thread, so saves land in order.  ``save`` copies
every tensor to host memory before it returns: the optimizer updates the
parameters in place, and a worker that read them later would write a later
step's values.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import re
import shutil
from typing import Any, Callable, List, Optional

import torch

Tree = Any

_STEP_RE = re.compile(r"^step_(\d+)$")
_SCALARS = (bool, int, float, str, type(None))


def _map(tree: Tree, fn: Callable[[str, Any], Any], path: str = "") -> Tree:
    """A tree of the same structure with every leaf replaced by fn(path, leaf),
    visited in a fixed order; a path names every key on the way."""
    if isinstance(tree, dict):
        return {key: _map(sub, fn, f"{path}[{key!r}]") for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(sub, fn, f"{path}[{i}]") for i, sub in enumerate(tree))
    return fn(path, tree)


def to_host(tree: Tree) -> Tree:
    """Copy every tensor leaf to host memory (a snapshot, never a view)."""
    return _map(tree, lambda _, x: x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x)


def save_checkpoint(ckpt_dir: str, step: int, state: Tree) -> str:
    """Synchronous atomic save. Returns the committed directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves: List[dict] = []

    def write(path, leaf):
        if isinstance(leaf, _SCALARS):
            leaves.append({"path": path, "value": leaf})
            return
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"checkpoint: unsupported leaf {type(leaf).__name__} at {path or '<root>'}")
        t = leaf.detach().to("cpu").contiguous()
        fname = f"leaf_{len(leaves):05d}.bin"
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        leaves.append({"path": path, "file": fname, "dtype": str(t.dtype).removeprefix("torch."), "shape": list(t.shape)})

    _map(state, write)
    manifest = {"step": int(step), "leaves": leaves}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _is_committed(d: str) -> bool:
    return os.path.isfile(os.path.join(d, "COMMIT"))


def list_steps(ckpt_dir: str) -> List[int]:
    """Steps with a committed checkpoint, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and _is_committed(os.path.join(ckpt_dir, name)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest committed step, or None."""
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _read_tensor(d: str, entry) -> torch.Tensor:
    dtype = getattr(torch, entry["dtype"])
    shape = entry["shape"]
    with open(os.path.join(d, entry["file"]), "rb") as f:
        buf = bytearray(f.read())
    if not buf:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(shape)


def restore_checkpoint(ckpt_dir: str, step: int, template: Tree) -> Tree:
    """Restore into the template's structure: each tensor leaf lands on the
    device of the template's leaf at the same path, scalars come back as
    they were saved."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    if not _is_committed(d):
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    with open(os.path.join(d, "manifest.json")) as f:
        by_path = {e["path"]: e for e in json.load(f)["leaves"]}

    def leaf(path, like):
        entry = by_path.get(path)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {path}")
        if "value" in entry:
            return entry["value"]
        t = _read_tensor(d, entry)
        return t.to(like.device) if isinstance(like, torch.Tensor) else t

    return _map(template, leaf)


class AsyncCheckpointer:
    """Single-worker async save queue (ordered; the last error surfaces in ``wait``)."""

    def __init__(self):
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: List[cf.Future] = []

    def save(self, ckpt_dir: str, step: int, state: Tree, then: Optional[Callable[[], None]] = None) -> cf.Future:
        """Snapshot ``state`` to host memory now, write it on the worker, then
        run ``then()`` there (after the commit, before the next save)."""
        host = to_host(state)

        def write():
            out = save_checkpoint(ckpt_dir, step, host)
            if then is not None:
                then()
            return out

        fut = self._pool.submit(write)
        self._pending.append(fut)
        return fut

    def wait(self) -> None:
        """Block until every queued save has landed; re-raise a failed one."""
        for fut in self._pending:
            fut.result()
        self._pending.clear()
