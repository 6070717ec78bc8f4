"""The serving engine: bucketed embedding forward passes (port of
``ServeEngine`` from ``repro/serve/engine.py``, single device).

``ServeEngine`` wraps the SSL encoder + projector (``repro_torch.train.ssl``)
behind the bucket ladder of ``repro_torch.serve.buckets``: inputs are
zero-padded to the request's bucket, the model runs eagerly under
``torch.no_grad``, and the padding is sliced off.  Rows are
independent through the MLP, so padding never leaks into real outputs.
``warmup`` runs every bucket once so no request pays a first-call cost.
Checkpoint loading, the mesh (data-parallel) and tp (feature-sharded)
forwards belong to later slices.
"""

from __future__ import annotations

from typing import Set, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.serve.buckets import BucketPolicy, bucket_for, bucket_sizes
from repro_torch.train.ssl import SSLModel, SSLModelConfig

Tensor = torch.Tensor


class ServeEngine:
    """Embedding forward over a bounded ladder of batch shapes."""

    def __init__(
        self,
        model_cfg: SSLModelConfig,
        model: SSLModel,
        *,
        policy: BucketPolicy = BucketPolicy(),
        device: DeviceLike = None,
    ):
        self.model_cfg = model_cfg
        self.policy = policy.validate()
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self._warm: Set[int] = set()

    @property
    def d(self) -> int:
        """Embedding width (the projector's output dimension)."""
        return int(self.model_cfg.projector_widths[-1])

    def warmup(self) -> Tuple[int, ...]:
        """Run every bucket once (zeros in), so no request pays a first call."""
        for b in bucket_sizes(self.policy):
            x = torch.zeros((b, self.model_cfg.input_dim), dtype=torch.float32, device=self.device)
            with torch.no_grad():
                self.model(x)
            self._warm.add(b)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return bucket_sizes(self.policy)

    def compiled_buckets(self) -> Tuple[int, ...]:
        """Batch sizes that have run at least once, ascending."""
        return tuple(sorted(self._warm))

    def encode(self, x) -> Tensor:
        """(n, input_dim) -> (n, d) on the engine's device: pad to the
        bucket, run, strip the padding.  Returns without synchronising."""
        if not isinstance(x, Tensor):
            x = torch.as_tensor(np.asarray(x, np.float32))
        x = x.to(device=self.device, dtype=torch.float32)
        if x.ndim == 1:
            x = x[None, :]
        n = x.shape[0]
        top = bucket_sizes(self.policy)[-1]
        if n > top:
            # coalescing can overshoot max_batch by one multi-row request
            # (and the naive bench feeds arbitrary n): chunk at the largest
            # bucket so every forward stays within the warmed ladder
            return torch.cat([self.encode(x[i : i + top]) for i in range(0, n, top)], dim=0)
        b = bucket_for(n, self.policy)
        if n < b:
            pad = torch.zeros((b - n, x.shape[1]), dtype=x.dtype, device=x.device)
            x = torch.cat([x, pad], dim=0)
        with torch.no_grad():
            z = self.model(x)
        self._warm.add(b)
        return z[:n]

