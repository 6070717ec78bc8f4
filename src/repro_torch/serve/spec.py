"""Self-drafting speculative decoding: the n-gram prompt-lookup drafter
(port of ``repro/serve/spec.py``; pure Python, copied — the port imports
nothing of the reference).

Per-slot decode on the paged pool is batch-1-like and memory-bound — every
tick streams the whole KV working set to produce ONE token per slot.
Speculative decoding converts that slack into tokens/step: a cheap drafter
proposes ``k`` candidate tokens, a single batched *verify* forward scores
all ``k + 1`` positions at once, and the longest prefix of the draft that
matches the model's own greedy choices is accepted.  Greedy verification
makes the emitted stream BIT-IDENTICAL to plain sequential greedy decode —
the standing serve acceptance gate — because every accepted token is, by
construction, exactly the token the model would have produced.

This module is the pure-Python half: the drafter and the acceptance rule.
No tensors, no KV pages — the engine (``ContinuousLMEngine``) owns the verify
forward and the scratch-page bookkeeping, the paging manager owns the
commit/rollback of speculative rows.

The drafter is a *prompt-lookup* / n-gram table (the prompt-lookup
decoding family): each slot keeps a suffix table over its own context (prompt +
every accepted token) mapping the last ``n`` tokens to positions where that
n-gram occurred before; a draft is simply the continuation of the most
recent earlier occurrence.  There is no draft model and therefore no draft
KV to page — the only accelerator cost speculation adds is the verify
forward, which replaces (not augments) the plain decode tick.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class SpecConfig:
    """Tunables for the self-drafting speculative decoder.

    ``draft_k`` is the maximum tokens proposed per tick (the verify forward
    scores ``draft_k + 1`` lanes per slot).  ``ngram_max``/``ngram_min``
    bound the suffix lengths tried by the prompt-lookup table, longest
    first — longer matches are rarer but much more likely to extend.
    """

    draft_k: int = 4
    ngram_max: int = 3
    ngram_min: int = 1

    def __post_init__(self):
        if self.draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {self.draft_k}")
        if not (1 <= self.ngram_min <= self.ngram_max):
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"[{self.ngram_min}, {self.ngram_max}]"
            )


class SlotDraft:
    """Per-slot prompt-lookup drafter: suffix table over prompt + emits.

    The table maps each n-gram (``ngram_min <= n <= ngram_max``) to the
    *end positions* of its most recent occurrences — ``j`` such that
    ``context[j - n : j] == ngram`` — keeping the last two.  Two, not one:
    pushing token ``t`` registers the context's new suffix at its own end
    position ``len(context)``, which at draft time IS the query n-gram and
    has no continuation yet.  Keeping the penultimate occurrence as well
    lets ``propose`` skip that self-match and still find the useful earlier
    one in O(1).
    """

    __slots__ = ("cfg", "context", "_table", "drafts", "draft_hits",
                 "proposed_total", "accepted_total")

    def __init__(self, cfg: SpecConfig, prompt: Sequence[int]):
        self.cfg = cfg
        self.context: List[int] = []
        # ngram tuple -> up to two most recent end positions, ascending
        self._table: Dict[Tuple[int, ...], List[int]] = {}
        self.drafts = 0            # propose() calls
        self.draft_hits = 0        # propose() calls that returned tokens
        self.proposed_total = 0    # tokens proposed across all drafts
        self.accepted_total = 0    # tokens accepted across all drafts
        for t in prompt:
            self.push(int(t))

    def push(self, token: int):
        """Append one context token (prompt feed or an accepted emit)."""
        self.context.append(int(token))
        end = len(self.context)
        for n in range(self.cfg.ngram_min, self.cfg.ngram_max + 1):
            if n > end:
                break
            key = tuple(self.context[end - n:end])
            slots = self._table.get(key)
            if slots is None:
                self._table[key] = [end]
            else:
                if len(slots) == 2:
                    slots.pop(0)
                slots.append(end)

    def propose(self, k: int) -> List[int]:
        """Draft ``k`` tokens continuing the current context.

        Tries suffix lengths from ``ngram_max`` down to ``ngram_min``; the
        first n-gram with an earlier occurrence wins and the draft is the
        tokens that followed it.  When the match sits fewer than ``k`` tokens
        from the context end — the common case once greedy decode settles
        into a cycle, where the nearest match is exactly one period back —
        the draft wraps around the matched continuation (period
        ``length - j``), extrapolating the cycle.  The verify forward scores
        a fixed ``draft_k + 1`` lanes either way, so over-proposing is free:
        wrong wrapped tokens are simply rejected.  Returns ``[]`` on a miss
        (the tick falls back to plain one-token decode for this slot).
        """
        self.drafts += 1
        ctx = self.context
        length = len(ctx)
        if k < 1 or length == 0:
            return []
        for n in range(min(self.cfg.ngram_max, length), self.cfg.ngram_min - 1, -1):
            key = tuple(ctx[length - n:length])
            positions = self._table.get(key)
            if not positions:
                continue
            # skip the self-match: the current suffix registered itself at
            # end position == length when its last token was pushed
            j: Optional[int] = None
            for cand in reversed(positions):
                if cand < length:
                    j = cand
                    break
            if j is None:
                continue
            period = length - j
            draft = [ctx[j + (i % period)] for i in range(k)]
            self.draft_hits += 1
            self.proposed_total += len(draft)
            return draft
        return []

    def observe_accept(self, n_accepted: int):
        """Record how many of the last draft's tokens the verify kept."""
        self.accepted_total += int(n_accepted)

    @property
    def hit_rate(self) -> float:
        """Fraction of propose() calls that produced a non-empty draft."""
        return self.draft_hits / self.drafts if self.drafts else 0.0


def draft_budget(draft_k: int, max_new_tokens: int, emitted: int) -> int:
    """Draft tokens scorable this tick without outrunning the request.

    A verify with ``k`` draft tokens can emit up to ``k + 1`` tokens and
    writes cache rows up to ``pos + k``; capping ``k`` at
    ``max_new_tokens - emitted - 1`` keeps both within the request's budget
    and its page reservation (``rows = prompt + max_new - 1``), so the
    boundary truncation IS the OOM-safety argument — no write can ever land
    past the reserved rows.
    """
    return max(0, min(int(draft_k), int(max_new_tokens) - int(emitted) - 1))


def accept_length(proposed: Sequence[int], outputs: Sequence[int]) -> int:
    """Longest accepted prefix of ``proposed`` under greedy verification.

    ``outputs[j]`` is the model's greedy next-token at position ``pos + j``
    — lane 0's input is the slot's last real token, lane ``j >= 1``'s input
    is ``proposed[j - 1]``.  A draft token is accepted while it equals the
    model's own choice at that position, so the emitted span is
    ``outputs[: a + 1]``: the ``a`` accepted draft tokens (which equal
    ``outputs[:a]``) plus the model's bonus token ``outputs[a]``.  This is
    exactly the sequential greedy stream, which is what makes speculative
    greedy decode bit-identical to plain decode.
    """
    a = 0
    limit = min(len(proposed), len(outputs) - 1)
    while a < limit and int(proposed[a]) == int(outputs[a]):
        a += 1
    return a


@dataclass
class SpecStats:
    """Service-level speculation counters (aggregated across slots)."""

    verify_steps: int = 0          # verify forwards executed
    plain_steps: int = 0           # ticks that fell back to plain decode
    tokens_emitted: int = 0        # tokens emitted by verify steps
    tokens_proposed: int = 0       # draft tokens scored by verify steps
    tokens_accepted: int = 0       # draft tokens accepted
    drafts: int = 0                # per-slot propose() calls
    draft_hits: int = 0            # ... that returned a non-empty draft
    rejects: int = 0               # verifies that truncated a draft
    slot_lanes: int = 0            # slot-lanes ridden on verify steps
    per_slot: Dict[int, int] = field(default_factory=dict)

    def accepted_per_step(self) -> float:
        """Mean tokens emitted per verify step (> 1 means speculation pays)."""
        return self.tokens_emitted / self.verify_steps if self.verify_steps else 0.0

    def acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens the verify accepted."""
        return self.tokens_accepted / self.tokens_proposed if self.tokens_proposed else 0.0

    def hit_rate(self) -> float:
        """Fraction of propose() calls that produced a draft."""
        return self.draft_hits / self.drafts if self.drafts else 0.0

    def metrics(self, prefix: str = "spec_") -> Dict[str, float]:
        """Flat metrics dict merged into the service scrape."""
        return {
            f"{prefix}verify_steps": float(self.verify_steps),
            f"{prefix}plain_steps": float(self.plain_steps),
            f"{prefix}tokens_emitted": float(self.tokens_emitted),
            f"{prefix}tokens_proposed": float(self.tokens_proposed),
            f"{prefix}tokens_accepted": float(self.tokens_accepted),
            f"{prefix}rejects": float(self.rejects),
            f"{prefix}accepted_tokens": self.accepted_per_step(),
            f"{prefix}acceptance_rate": self.acceptance_rate(),
            f"{prefix}draft_hit_rate": self.hit_rate(),
        }
