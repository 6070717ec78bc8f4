"""Host data pipeline: background prefetch + device placement with the
batch's sharding (port of ``repro/data/pipeline.py``).

``ShardedPrefetcher`` wraps any iterator of batches (a dict of numpy arrays
or tensors, or one array): a worker thread keeps ``depth`` batches ahead,
overlapping host data generation with the device's step, and places each
batch on the device before the step asks for it.

  * ``sharding`` (a ``parallel.sharding.NamedSharding``) cuts this rank's
    block out of each full batch (``NamedSharding.local``), as the
    reference's ``jax.device_put`` with the batch sharding lays out each
    device's slice; ``process_local=True`` takes the iterator's batch as
    this rank's own block already (the reference's
    ``make_array_from_process_local_data`` path).
  * On CUDA each leaf is copied from pinned host memory with
    ``non_blocking=True`` on a side stream, and the batch carries an event
    recorded after its copies: ``__next__`` makes the consumer's current
    stream wait on it before the batch is handed out, so the step never
    reads a batch still in flight, and the host never waits for the copy.

A worker exception is raised at the next ``__next__``; ``StopIteration``
comes once the iterator is exhausted.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device

_END = object()


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return fn(batch)


class ShardedPrefetcher:
    def __init__(
        self,
        it: Iterator[Any],
        sharding=None,
        depth: int = 2,
        *,
        process_local: bool = False,
        device: DeviceLike = None,
    ):
        self._it = it
        self._sharding = sharding
        self._process_local = bool(process_local)
        self.device = resolve_device(device)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _leaf(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        if self._sharding is not None and not self._process_local:
            t = self._sharding.local(t)
        if self._stream is None:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _place(self, batch):
        """(batch on the device, the event its copies finish at or None)."""
        if self._stream is None:
            return _map(self._leaf, batch), None
        with torch.cuda.stream(self._stream):
            out = _map(self._leaf, batch)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _worker(self):
        try:
            for batch in self._it:
                if self._stop.is_set():
                    return
                self._q.put(self._place(batch))
        except BaseException as e:  # surfaced on the next __next__
            self._err = e
        self._q.put(_END)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _END:
            self._q.put(_END)  # every later call ends too
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, ready = item
        if ready is not None:
            # the consumer's stream waits for the copies, and the tensors
            # (made on the side stream) are marked as used on it, so the
            # allocator does not hand their memory out while the step reads
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            _map(lambda t: t.record_stream(stream), batch)
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
