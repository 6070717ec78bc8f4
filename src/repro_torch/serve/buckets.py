"""Shape buckets + admission policy for the serving micro-batcher (port of
``repro/serve/buckets.py``).

Requests are coalesced into a bounded geometric ladder of batch sizes; a
batch of n rows is padded up to ``bucket_for(n)`` rows and the padding
sliced off the result, so the engine sees at most
``len(bucket_sizes(policy))`` distinct shapes, all warmed up front.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.kernels.utils import next_multiple

# The reference aligns buckets to the TPU's f32 sublane tile; the port keeps
# the same ladder so both serve identical batch shapes.
SUBLANE = 8


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Admission policy of the dynamic micro-batcher.

    max_batch:    largest bucket (requests per dispatch cap)
    max_wait_ms:  latency budget — after the first queued request, dispatch
                  no later than this even if the bucket is not full
    max_queue:    backpressure bound — ``submit`` refuses beyond this depth
    align:        bucket granularity (default 8, the reference's ladder)
    """

    max_batch: int = 64
    max_wait_ms: float = 2.0
    max_queue: int = 1024
    align: int = SUBLANE

    def validate(self) -> "BucketPolicy":
        """Sanity-check the knobs; returns self for chaining."""
        if self.max_batch < 1 or self.align < 1:
            raise ValueError(f"max_batch and align must be >= 1, got {self.max_batch}, {self.align}")
        if self.max_wait_ms < 0.0:
            raise ValueError(f"max_wait_ms must be >= 0, got {self.max_wait_ms}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        return self


def bucket_sizes(policy: BucketPolicy) -> Tuple[int, ...]:
    """The geometric ladder of batch buckets: align, 2*align, ... >= max_batch."""
    policy.validate()
    sizes: List[int] = []
    b = policy.align
    while b < policy.max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(next_multiple(policy.max_batch, policy.align))
    return tuple(sizes)


def bucket_for(n: int, policy: BucketPolicy) -> int:
    """Smallest bucket holding n rows (n is clamped to max_batch upstream)."""
    if n < 1:
        raise ValueError(f"bucket_for needs n >= 1, got {n}")
    for b in bucket_sizes(policy):
        if b >= n:
            return b
    return bucket_sizes(policy)[-1]


def bucket_shapes(policy: BucketPolicy, d: int) -> List[Tuple[int, int]]:
    """(bucket, d) pairs — the pre-tune / warmup job list for one width."""
    return [(b, d) for b in bucket_sizes(policy)]
