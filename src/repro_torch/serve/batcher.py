"""Dynamic micro-batcher: coalesce queued requests into shape buckets
(port of ``repro/serve/batcher.py``; framework-free host code, copied so the
port imports nothing of ``repro``).

The batcher owns the REQUEST side of serving: a bounded FIFO queue with
backpressure, per-request futures, and the admission policy (dispatch when a
full ``max_batch`` is waiting, or ``max_wait_ms`` after the first request
arrived — whichever comes first).  It is engine-agnostic: a dispatch loop
(``repro_torch.serve.service``) pops coalesced batches with ``next_batch`` and
completes the futures.  All math (padding to the bucket, the forward pass)
happens downstream.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, List, Optional

from repro_torch.serve.buckets import BucketPolicy


class Backpressure(RuntimeError):
    """The request queue is full — the caller must shed load or retry."""


class ServeFuture:
    """Minimal thread-safe future for one request's result."""

    def __init__(self):
        self._done = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None  # first token emitted (LM requests)
        self.t_done: Optional[float] = None

    def set_result(self, value: Any):
        """Resolve the future with the request's result."""
        self._value = value
        self.t_done = time.perf_counter()
        self._done.set()

    def set_exception(self, err: BaseException):
        """Fail the future; ``result()`` re-raises the error."""
        self._error = err
        self.t_done = time.perf_counter()
        self._done.set()

    def done(self) -> bool:
        """True once a result or an exception has been set."""
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block until resolved; return the value or re-raise."""
        if not self._done.wait(timeout):
            raise TimeoutError("serve request did not complete in time")
        if self._error is not None:
            raise self._error
        return self._value

    @property
    def latency_s(self) -> Optional[float]:
        """Submit-to-done wall time in seconds (None while pending)."""
        return None if self.t_done is None else self.t_done - self.t_submit

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit-to-first-token wall time in seconds (LM requests)."""
        return None if self.t_first is None else self.t_first - self.t_submit


class Request:
    """One queued request: the payload plus its future.

    The payload is opaque to the batcher — embedding traffic queues input
    row arrays, coalesced by ``rows``."""

    __slots__ = ("x", "future")

    def __init__(self, x):
        self.x = x
        self.future = ServeFuture()

    @property
    def rows(self) -> int:
        """Input rows this request contributes to a batch."""
        return 1 if getattr(self.x, "ndim", 1) == 1 else int(self.x.shape[0])


_SHUTDOWN = object()


class MicroBatcher:
    """Bounded request queue + coalescing admission policy."""

    def __init__(self, policy: BucketPolicy = BucketPolicy()):
        self.policy = policy.validate()
        self._q: "queue.Queue" = queue.Queue(maxsize=policy.max_queue)
        self._shutdown = threading.Event()

    # -- producer side ------------------------------------------------------

    def submit(self, x, *, block: bool = False, timeout: Optional[float] = None) -> ServeFuture:
        """Enqueue one request.  Non-blocking by default: raises
        ``Backpressure`` when the queue is at ``max_queue`` (the caller is
        expected to 429 / shed load); ``block=True`` waits up to ``timeout``.
        Raises ``Backpressure`` unconditionally after ``shutdown``."""
        if self._shutdown.is_set():
            raise Backpressure("serve queue is shutting down; not accepting requests")
        req = Request(x)
        try:
            self._q.put(req, block=block, timeout=timeout)
        except queue.Full:
            raise Backpressure(
                f"serve queue full ({self.policy.max_queue} pending); shed load"
            ) from None
        return req.future

    def depth(self) -> int:
        """Requests currently waiting in the queue."""
        return self._q.qsize()

    def shutdown(self):
        """Stop admitting requests; ``next_batch`` drains what is queued and
        then returns None.  The signal is an event, not a queued sentinel, so
        shutting down never blocks on a full queue — the best-effort sentinel
        below only wakes a dispatch loop blocked in an indefinite get."""
        self._shutdown.set()
        try:
            self._q.put_nowait(_SHUTDOWN)
        except queue.Full:
            pass  # queue non-empty -> a blocked get cannot exist

    # -- consumer side ------------------------------------------------------

    def next_batch(self, timeout: Optional[float] = None) -> Optional[List[Request]]:
        """Block up to ``timeout`` for the first request, then coalesce FIFO
        until ``max_batch`` rows are gathered or ``max_wait_ms`` has elapsed
        since the first request was popped.  Returns [] on timeout with an
        empty queue and None once ``shutdown`` was called and the queue has
        drained (queued requests are always flushed first)."""
        try:
            first = self._q.get(block=timeout != 0.0, timeout=timeout)
        except queue.Empty:
            return None if self._shutdown.is_set() else []
        if first is _SHUTDOWN:
            # the wake-up sentinel; anything still queued drains on the next
            # call (submit is already refusing new work)
            return None if self._q.empty() else []
        batch = [first]
        rows = first.rows
        deadline = time.perf_counter() + self.policy.max_wait_ms / 1e3
        while rows < self.policy.max_batch:
            remaining = deadline - time.perf_counter()
            try:
                nxt = self._q.get(block=remaining > 0, timeout=max(remaining, 0) or None)
            except queue.Empty:
                break
            if nxt is _SHUTDOWN:
                # flush this batch; the event flag carries the signal onward
                break
            batch.append(nxt)
            rows += nxt.rows
        return batch

    def next_requests(self, max_n: int, timeout: Optional[float] = None) -> Optional[List[Request]]:
        """Pop up to ``max_n`` whole requests — continuous-batching
        admission: a freed decode slot takes the next queued request NOW, it
        never waits to coalesce a batch (``max_wait_ms`` does not apply).
        Returns [] when nothing is queued within ``timeout`` (or ``max_n ==
        0``) and None once ``shutdown`` was called and the queue has drained."""
        if max_n <= 0:
            return None if self._shutdown.is_set() and self._q.empty() else []
        try:
            first = self._q.get(block=timeout != 0.0, timeout=timeout)
        except queue.Empty:
            return None if self._shutdown.is_set() else []
        if first is _SHUTDOWN:
            return None if self._q.empty() else []
        batch = [first]
        while len(batch) < max_n:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is _SHUTDOWN:
                break
            batch.append(nxt)
        return batch
