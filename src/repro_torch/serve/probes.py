"""Online decorrelation probes for the serve path (port of
``repro/serve/probes.py``).

Wraps ``repro_torch.decorr.probe_metrics`` in a streaming monitor: served
rows are buffered into fixed ``sample_rows`` windows, each full window is
probed, per-window values fold into exponential moving averages, and
per-feature first/second moments are EMA'd as length-d vectors.

The feature permutation of probe step t is ``permutation(t, d)``; the
default draws it from a seeded ``torch.Generator`` per step
(``core/permutation.permutation_for_step``), so a reading is reproducible
offline.  A caller comparing with the reference passes the reference's own
indices instead (JAX's threefry stream cannot be reproduced in PyTorch).

``metrics()`` exports one flat ``{str: float}`` dict, the scrape surface.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.permutation import permutation_for_step
from repro_torch.decorr.config import DecorrConfig
from repro_torch.decorr.probe import probe_metrics

Tensor = torch.Tensor
Permutation = Callable[[int, int], Tensor]


class DecorrProbe:
    """Streaming representation-health monitor for served embeddings."""

    def __init__(
        self,
        cfg: DecorrConfig = DecorrConfig(style="vic", reg="sum", q=2),
        *,
        ema: float = 0.99,
        perm_seed: int = 0,
        permutation: Optional[Permutation] = None,
        include_off: Optional[bool] = None,
        sample_rows: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.cfg = cfg.validate()
        self.ema = float(ema)
        self.device = resolve_device(device)
        self.permutation = permutation or functools.partial(permutation_for_step, perm_seed)
        self._include_off = include_off
        # observe() coalesces rows into fixed (sample_rows, d) windows, so
        # every probe sees one shape whatever the micro-batch sizes are
        self.sample_rows = sample_rows
        self._buf: List[Tensor] = []
        self._buf_rows = 0
        self._step = 0
        self._last: Dict[str, float] = {}
        self._avg: Dict[str, float] = {}
        self._mean_ema: Optional[np.ndarray] = None
        self._m2_ema: Optional[np.ndarray] = None
        # per-executable timing (repro_torch.obs.ExecTimer); services attach
        # obs.perf when telemetry is enabled
        self.perf = None

    def _rows(self, z) -> Tensor:
        if not isinstance(z, Tensor):
            z = torch.as_tensor(np.asarray(z, np.float32))
        return z.to(device=self.device, dtype=torch.float32)

    # -- streaming update ---------------------------------------------------

    def update(self, z1, z2=None) -> Dict[str, float]:
        """Fold one served batch into the stream; returns this batch's metrics."""
        z1 = self._rows(z1)
        z2 = None if z2 is None else self._rows(z2)
        perm = self.permutation(self._step, z1.shape[-1])
        t0 = self.perf.start() if self.perf is not None else 0.0
        vals = probe_metrics(z1, z2, self.cfg, perm, include_off=self._include_off)
        m1 = torch.mean(z1, dim=0)
        m2 = torch.mean(z1 * z1, dim=0)
        # one device->host transfer for everything; EMAs fold in numpy
        keys = list(vals)
        packed = torch.cat([torch.stack([vals[k] for k in keys]), m1, m2]).cpu().numpy()
        k = len(keys)
        d = m1.shape[0]
        m1, m2 = packed[k : k + d], packed[k + d :]
        if self.perf is not None:  # the host copy above is the sync point
            self.perf.observe("probe_update", self.perf.elapsed(t0))
        batch = {key: float(v) for key, v in zip(keys, packed[:k])}
        a = self.ema
        for key, v in batch.items():
            self._avg[key] = v if key not in self._avg else a * self._avg[key] + (1 - a) * v
        self._mean_ema = m1 if self._mean_ema is None else a * self._mean_ema + (1 - a) * m1
        self._m2_ema = m2 if self._m2_ema is None else a * self._m2_ema + (1 - a) * m2
        self._last = batch
        self._step += 1
        return batch

    def warmup(self, d: int):
        """Run the probe once on a zero window without folding anything into
        the stream — builds the CUDA kernels before the first request (with
        a timer: the first-call gauge, then the roofline join of
        ``probe_update`` analysed on fake copies)."""
        zero = torch.zeros((self.sample_rows or 8, d), dtype=torch.float32, device=self.device)
        perm = self.permutation(0, d)
        t0 = self.perf.start() if self.perf is not None else 0.0
        probe_metrics(zero, None, self.cfg, perm, include_off=self._include_off)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.perf is not None:
            self.perf.record_compile("probe_update", self.perf.elapsed(t0))
            self.perf.attach_jit("probe_update", functools.partial(
                probe_metrics, cfg=self.cfg, include_off=self._include_off), zero, None, perm=perm)

    def observe(self, z) -> int:
        """Streaming entry point: buffer served rows and fold a probe update
        for every full ``sample_rows`` window (``sample_rows=None`` probes
        each call at once).  Returns the probe updates fired."""
        if self.sample_rows is None:
            self.update(z)
            return 1
        z = self._rows(z)
        self._buf.append(z)
        self._buf_rows += int(z.shape[0])
        fired = 0
        while self._buf_rows >= self.sample_rows:
            flat = torch.cat(self._buf, dim=0)
            sample, rest = flat[: self.sample_rows], flat[self.sample_rows :]
            self._buf = [rest] if rest.shape[0] else []
            self._buf_rows = int(rest.shape[0])
            self.update(sample)
            fired += 1
        return fired

    # -- scrape surface -----------------------------------------------------

    @property
    def steps(self) -> int:
        """Probe updates folded so far (window t used ``permutation(t, d)``)."""
        return self._step

    def feature_moments(self):
        """(EMA mean, EMA var) per feature — length-d drift vectors."""
        if self._mean_ema is None:
            return None, None
        var = np.maximum(self._m2_ema - self._mean_ema**2, 0.0)
        return self._mean_ema, var

    def metrics(self, prefix: str = "decorr_") -> Dict[str, float]:
        """Latest probe values as flat ``decorr_*`` gauges."""
        out = {f"{prefix}probe_steps": float(self._step)}
        for k, v in self._last.items():
            out[f"{prefix}{k}"] = v
        for k, v in self._avg.items():
            out[f"{prefix}{k}_ema"] = v
        mean, var = self.feature_moments()
        if mean is not None:
            out[f"{prefix}feat_mean_abs_ema"] = float(np.mean(np.abs(mean)))
            out[f"{prefix}feat_var_ema"] = float(np.mean(var))
        return out
