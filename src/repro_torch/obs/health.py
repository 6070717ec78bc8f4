"""Train-side decorrelation-health monitor (port of ``repro/obs/health.py``).

The FFT relaxation (R_sum over circulant off-diagonal sums) is what makes
large-d training affordable, but the paper is explicit about its failure
mode: the relaxed objective admits undesirable minima — feature collapse
and shifted-identity cross-correlations — that the exact off-diagonal
penalty would reject.  Barlow Twins and VICReg frame their regularizers as
collapse defenses; a production train loop therefore needs the collapse
signals on the scrape path, not in a notebook.

``DecorrHealthMonitor`` wraps the serve-side streaming :class:`DecorrProbe`
for the train loop:

  * **relaxation gap** — ``|R_sum_norm - R_off_norm|`` (exact vs relaxed),
    the direct estimate of how far the FFT relaxation has drifted from the
    objective it stands in for.  Only emitted when the probe computes the
    exact term (small d or ``include_off=True``); when absent, the gap rules
    simply never trigger (absent metrics leave alert rules untouched).
  * **per-feature variance histogram** — the cross-section of the embedding
    stream, so a scrape can distinguish "all features dying" from "a few
    dead channels".
  * **EMA collapse indicators** — min/mean EMA feature variance and the
    fraction of features below a collapse floor.

The monitor is pull-based and cheap: call :meth:`update` from the train
loop's log-interval branch (not every step) with the current params and a
batch; it embeds, probes, and publishes ``train_decorr_*`` gauges that the
new :func:`repro_torch.obs.alerts.default_train_rules` evaluate on scrape.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.obs.registry import MetricsRegistry

# log-spaced buckets for per-feature variance: collapse shows up as mass
# piling below ~1e-4, healthy BN-normalized features sit near 1.0
VAR_BUCKETS = (1e-8, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 0.5, 1.0, 2.0, 10.0, 100.0)

COLLAPSE_FLOOR = 1e-4


class DecorrHealthMonitor:
    """Streaming decorrelation-health probe for the training loop.

    Parameters
    ----------
    embed_fn:
        ``embed_fn(params, batch) -> z`` mapping the train state's params and
        a batch to the (n, d) embedding matrix to probe.  Optional — callers
        that already hold embeddings can use :meth:`observe` directly.
    cfg, ema, sample_rows, include_off, device:
        forwarded to :class:`repro_torch.serve.probes.DecorrProbe`.  ``ema=0.0``
        makes every indicator track the latest batch exactly (useful in
        tests); the default keeps a short memory so one noisy batch doesn't
        fire an alert on its own (window smoothing happens again in the
        alert rules).  ``device`` is where the probe runs (``cuda`` unless
        ``"cpu"`` is given): the R_sum route follows it, kernels on CUDA.
    """

    def __init__(
        self,
        embed_fn: Optional[Callable[[Any, Any], Any]] = None,
        *,
        cfg=None,
        ema: float = 0.9,
        sample_rows: Optional[int] = None,
        include_off: Optional[bool] = None,
        device=None,
    ):
        # lazy import: repro_torch.obs must stay importable without the serve stack
        from repro_torch.serve.probes import DecorrProbe

        self.embed_fn = embed_fn
        kw: Dict[str, Any] = {"ema": ema, "device": device}
        if sample_rows is not None:
            kw["sample_rows"] = sample_rows
        if include_off is not None:
            kw["include_off"] = include_off
        self.probe = DecorrProbe(cfg, **kw) if cfg is not None else DecorrProbe(**kw)
        self.updates = 0
        self._gap_ema: Optional[float] = None
        self._ema = float(ema)

    def observe(self, z, *, registry: Optional[MetricsRegistry] = None) -> Dict[str, float]:
        """Probe one embedding matrix and return (and optionally publish)
        the ``train_decorr_*`` health metrics."""
        import numpy as np

        self.probe.update(z)
        self.updates += 1
        m = self.probe.metrics(prefix="train_decorr_")

        r_sum = m.get("train_decorr_r_sum_norm")
        r_off = m.get("train_decorr_r_off_norm")
        if r_sum is not None and r_off is not None:
            gap = abs(float(r_sum) - float(r_off))
            m["train_decorr_relaxation_gap"] = gap
            prev = self._gap_ema
            self._gap_ema = gap if prev is None else self._ema * prev + (1.0 - self._ema) * gap
            m["train_decorr_relaxation_gap_ema"] = self._gap_ema

        feat_var = None
        moments = getattr(self.probe, "feature_moments", None)
        if callable(moments):
            try:
                _, feat_var = moments()
            except Exception:
                feat_var = None
        if feat_var is not None:
            v = np.asarray(feat_var, dtype=np.float64).ravel()
            if v.size:
                m["train_decorr_feat_var_min_ema"] = float(v.min())
                m["train_decorr_collapsed_frac"] = float((v < COLLAPSE_FLOOR).mean())

        m["train_decorr_updates"] = float(self.updates)

        if registry is not None:
            registry.publish(m)
            if feat_var is not None and v.size:
                h = registry.histogram(
                    "train_feat_var",
                    "per-feature EMA variance of the probed embedding stream",
                    buckets=VAR_BUCKETS,
                )
                for val in v:
                    h.observe(float(val))
        return m

    def update(
        self,
        state_or_params,
        batch,
        *,
        step: Optional[int] = None,
        registry: Optional[MetricsRegistry] = None,
    ) -> Dict[str, float]:
        """Embed a batch with the current params and probe the result.

        Accepts either a train state (its ``model``, or anything with
        ``.params``) or bare params; ``embed_fn`` runs under
        ``torch.no_grad``.  ``step`` is recorded as a gauge when given.
        """
        if self.embed_fn is None:
            raise ValueError("DecorrHealthMonitor needs embed_fn to use update(); "
                             "call observe(z) with precomputed embeddings instead")
        params = getattr(state_or_params, "model", None)
        if params is None:
            params = getattr(state_or_params, "params", state_or_params)
        with torch.no_grad():
            z = self.embed_fn(params, batch)
        m = self.observe(z, registry=registry)
        if step is not None:
            m["train_decorr_step"] = float(step)
            if registry is not None:
                registry.publish({"train_decorr_step": float(step)})
        return m

    def metrics(self) -> Dict[str, float]:
        """Latest probe view without a new update (scrape-side read)."""
        m = self.probe.metrics(prefix="train_decorr_")
        if self._gap_ema is not None:
            m["train_decorr_relaxation_gap_ema"] = self._gap_ema
        m["train_decorr_updates"] = float(self.updates)
        return m
