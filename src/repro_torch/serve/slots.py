"""Decode-step-granular slot pool for continuous LM batching (port of
``repro/serve/slots.py``; pure Python bookkeeping).

The engine owns a fixed pool of N *slots*; every decode step runs all slots
batched, and a slot whose request retired (EOS / token budget) is handed
back and refilled from the queue on the very next step.  This module holds
the slot lifecycle (free -> active -> retired -> free), per-slot decode
positions (``cache_lens``), last-emitted tokens (``last_tokens``) and
occupancy accounting, plus each slot's sampling stream, chunked-prefill
progress and speculative drafter.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.serve.sampling import SamplingParams, make_rng


@dataclasses.dataclass
class LMRequest:
    """One queued generation request (the batcher payload).

    ``tokens``: 1-D int prompt; ``max_new_tokens`` >= 1 caps generation;
    ``eos_id`` (optional) retires the request early when emitted;
    ``sampling`` (optional) carries the per-request temperature / top-k /
    seed — None means greedy through the argmax path.
    """

    tokens: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    sampling: Optional[SamplingParams] = None

    @property
    def prompt_len(self) -> int:
        """Prompt length in tokens."""
        return int(np.shape(self.tokens)[0])

    @property
    def rows_needed(self) -> int:
        """Cache rows the request can ever write: the prompt plus every
        generated token EXCEPT the last (it is emitted, never written)."""
        return self.prompt_len + self.max_new_tokens - 1


class ActiveSlot:
    """Bookkeeping for one in-flight request bound to a pool slot."""

    __slots__ = (
        "request", "future", "index", "pos", "last_token", "emitted", "rng", "prefill_pos", "draft",
    )

    def __init__(self, request: LMRequest, future, index: int, seq: int = 0):
        self.request = request
        self.future = future
        self.index = index
        # pos == the slot's cache_len for its next decode step: the row the
        # last emitted token is WRITTEN at.  Prefill fills rows
        # [0, prompt_len) and emits the first token without writing it.
        self.pos = request.prompt_len - 1
        self.last_token: int = 0
        self.emitted: List[int] = []
        # per-request random stream (None for greedy); the pool's admission
        # counter seeds requests that did not pin their own seed
        self.rng = make_rng(request.sampling, fallback_seed=seq)
        # chunked prefill progress: prompt tokens already written to the
        # cache.  >= prompt_len (or no chunking) means the slot is decoding.
        self.prefill_pos: int = request.prompt_len
        # speculative drafter (serve.spec.SlotDraft) when the engine runs
        # with speculation
        self.draft = None

    @property
    def prefilling(self) -> bool:
        """True while the prompt is still prefilling (chunked path)."""
        return self.prefill_pos < self.request.prompt_len

    def emit(self, token: int) -> bool:
        """Record one generated token; True when the request is finished."""
        self.emitted.append(int(token))
        self.last_token = int(token)
        self.pos += 1
        if self.draft is not None:
            self.draft.push(int(token))
        if self.request.eos_id is not None and int(token) == int(self.request.eos_id):
            return True
        return len(self.emitted) >= self.request.max_new_tokens


class SlotPool:
    """Fixed pool of decode slots with free-list admission and occupancy
    accounting.  ``cache_lens`` / ``last_tokens`` are what the engine feeds
    the batched decode step."""

    def __init__(self, n_slots: int, max_len: int):
        assert n_slots >= 1 and max_len >= 2, (n_slots, max_len)
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self._slots: List[Optional[ActiveSlot]] = [None] * n_slots
        self._free: List[int] = list(range(n_slots - 1, -1, -1))  # pop() -> slot 0 first
        self.steps = 0
        self.active_slot_steps = 0
        self.admitted_total = 0
        self.retired_total = 0

    def free_slots(self) -> int:
        """Slots currently free."""
        return len(self._free)

    def active(self) -> List[ActiveSlot]:
        """The active slots, in pool order."""
        return [s for s in self._slots if s is not None]

    def active_indices(self) -> List[int]:
        """Indices of the active slots, ascending."""
        return [i for i, s in enumerate(self._slots) if s is not None]

    def decoding_indices(self) -> List[int]:
        """Active slots actually decoding this step (chunked prefill keeps a
        slot occupied but out of the batched decode until its prompt is in)."""
        return [i for i, s in enumerate(self._slots) if s is not None and not s.prefilling]

    def __getitem__(self, i: int) -> Optional[ActiveSlot]:
        return self._slots[i]

    def admit(self, request: LMRequest, future) -> ActiveSlot:
        """Claim a free slot for a request (the caller checked capacity)."""
        if not self._free:
            raise RuntimeError("no free slot; check free_slots() before admit")
        need = request.rows_needed
        if need > self.max_len:
            raise ValueError(f"request needs {need} cache rows > pool max_len={self.max_len}")
        slot = ActiveSlot(request, future, self._free.pop(), seq=self.admitted_total)
        self._slots[slot.index] = slot
        self.admitted_total += 1
        return slot

    def retire(self, index: int) -> ActiveSlot:
        """Free a slot and return its final state."""
        slot = self._slots[index]
        assert slot is not None, f"slot {index} is not active"
        self._slots[index] = None
        self._free.append(index)
        self.retired_total += 1
        return slot

    def cache_lens(self) -> np.ndarray:
        """(N,) int32 per-slot decode positions (0 for free AND still
        prefilling slots: their lane still computes, masked to one row; the
        output is discarded and, in paged mode, the write lands on the
        sentinel page)."""
        return np.asarray([0 if s is None or s.prefilling else s.pos for s in self._slots], np.int32)

    def last_tokens(self) -> np.ndarray:
        """(N,) int32 per-slot last emitted token (decode-step input)."""
        return np.asarray([0 if s is None else s.last_token for s in self._slots], np.int32)

    def observe_step(self):
        """Count one decode step (before that step's retirements): the lanes
        that decoded a live request (slots still chunk-prefilling occupy a
        lane but do not decode)."""
        self.steps += 1
        self.active_slot_steps += len(self.decoding_indices())

    def occupancy(self) -> float:
        """Mean fraction of slots doing useful work per decode step."""
        denom = self.steps * self.n_slots
        return self.active_slot_steps / denom if denom else 0.0

    def metrics(self, prefix: str = "slots_") -> dict:
        """Flat gauge dict of pool occupancy and throughput counters."""
        return {
            f"{prefix}total": float(self.n_slots),
            f"{prefix}active": float(self.n_slots - len(self._free)),
            f"{prefix}occupancy": self.occupancy(),
            f"{prefix}admitted_total": float(self.admitted_total),
            f"{prefix}retired_total": float(self.retired_total),
            f"{prefix}decode_steps": float(self.steps),
        }
