"""Typed metrics registry: Counter / Gauge / Histogram with labels, and
Prometheus text exposition.

Port of ``repro/obs/registry.py``: the standard library only, the same
behaviour and output text line for line.

The registry is the one scrape surface every layer publishes into.  Design
points, all driven by how the serve/train loops use it:

  * **get-or-create is the API.**  ``registry.counter(name)`` returns the
    existing metric when the name is already registered (and raises on a
    *type* conflict), so hot loops can look metrics up by name without
    threading objects around.  ``registry.publish(flat_dict)`` turns a legacy
    ``metrics()`` gauge dict into registry gauges in one call — that is how
    the services stay scrape-compatible while the registry becomes the
    source of truth.
  * **Label cardinality is bounded.**  Every labelled metric caps its
    distinct label sets (``max_label_sets``); the cap raises instead of
    silently growing, because unbounded label cardinality is the classic way
    a metrics pipeline OOMs itself at production traffic.
  * **Names are sanitized, not rejected.**  Legacy keys (``heartbeat_age_s``
    per component, probe metrics) may carry dots/colons; ``sanitize_name``
    maps them onto the Prometheus grammar ``[a-zA-Z_][a-zA-Z0-9_]*`` so one
    naming scheme serves the flat dicts AND the exposition format.
  * **Everything is process-local and lock-guarded** — the dispatch thread
    beats while the scrape thread reads.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

_INVALID = re.compile(r"[^a-zA-Z0-9_]")

# latency-shaped default buckets (seconds): 100us .. 10s, roughly log-spaced
DEFAULT_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def sanitize_name(name: str) -> str:
    """Map an arbitrary gauge key onto the Prometheus metric-name grammar."""
    out = _INVALID.sub("_", str(name))
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _escape_label(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_key(labelnames: Sequence[str], labels: Mapping[str, str]) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(f"expected labels {tuple(labelnames)}, got {tuple(labels)}")
    return tuple(str(labels[n]) for n in labelnames)


def format_labels(labelnames: Sequence[str], values: Sequence[str]) -> str:
    if not labelnames:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label(v)}"' for n, v in zip(labelnames, values)
    )
    return "{" + inner + "}"


class Metric:
    """Base: one named metric family, children keyed by label values."""

    kind = "untyped"

    def __init__(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        *,
        max_label_sets: int = 64,
        lock: Optional[threading.RLock] = None,
    ):
        self.name = sanitize_name(name)
        self.help = help
        self.labelnames = tuple(labelnames)
        for ln in self.labelnames:
            if sanitize_name(ln) != ln:
                raise ValueError(f"invalid label name {ln!r} on metric {self.name}")
        self.max_label_sets = int(max_label_sets)
        self._lock = lock or threading.RLock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **labels):
        """The child for one label set (cardinality-guarded get-or-create)."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self.max_label_sets:
                    raise ValueError(
                        f"metric {self.name}: label cardinality cap "
                        f"({self.max_label_sets}) exceeded; aggregate before export"
                    )
                child = self._new_child()
                self._children[key] = child
            return child

    def _default_child(self):
        if self.labelnames:
            raise ValueError(f"metric {self.name} is labelled; call .labels(...) first")
        with self._lock:
            if () not in self._children:
                self._children[()] = self._new_child()
            return self._children[()]

    def samples(self) -> List[Tuple[str, Tuple[str, ...], float]]:
        """Flat (suffix, label values, value) rows for exposition/as_dict."""
        with self._lock:
            out = []
            for key, child in sorted(self._children.items()):
                out.extend(child.samples(key))
            return out


class _Value:
    __slots__ = ("_v", "_lock")

    def __init__(self, lock):
        self._v = 0.0
        self._lock = lock

    @property
    def value(self) -> float:
        return self._v


class _CounterChild(_Value):
    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError(f"counters are monotone; inc({amount}) is not allowed")
        with self._lock:
            self._v += float(amount)

    def samples(self, key):
        return [("", key, self._v)]


class _GaugeChild(_Value):
    def set(self, value: float):
        with self._lock:
            self._v = float(value)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._v += float(amount)

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    def samples(self, key):
        return [("", key, self._v)]


class _HistogramChild:
    __slots__ = ("_lock", "bounds", "counts", "sum", "count")

    def __init__(self, lock, bounds):
        self._lock = lock
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last bucket is +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float):
        v = float(value)
        with self._lock:
            i = 0
            for i, b in enumerate(self.bounds):
                if v <= b:
                    break
            else:
                i = len(self.bounds)
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """Cumulative (le, count) pairs, ending at +Inf."""
        with self._lock:
            acc, out = 0, []
            for b, c in zip(list(self.bounds) + [math.inf], self.counts):
                acc += c
                out.append((b, acc))
            return out

    def samples(self, key):
        rows = [
            ("_bucket", key + (("+Inf" if math.isinf(le) else repr(float(le))),), float(c))
            for le, c in self.bucket_counts()
        ]
        rows.append(("_sum", key, self.sum))
        rows.append(("_count", key, float(self.count)))
        return rows


def quantile_from_buckets(bounds: Sequence[float], counts: Sequence[int],
                          q: float) -> float:
    """``histogram_quantile``-style estimate from per-bucket counts.

    ``bounds``: finite ascending upper bounds; ``counts``: per-bucket (NOT
    cumulative) observation counts with the +Inf bucket last
    (``len(counts) == len(bounds) + 1``).  Linear interpolation inside the
    bucket holding the target rank (from 0 at the bucket's lower bound);
    ranks in the +Inf bucket clamp to the highest finite bound, matching
    Prometheus.  Returns 0.0 for an empty histogram."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = q * total
    acc, lo = 0.0, 0.0
    for b, c in zip(bounds, counts):
        if c > 0 and acc + c >= rank:
            return lo + (b - lo) * max(rank - acc, 0.0) / c
        acc += c
        lo = b
    return float(bounds[-1])


class Counter(Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild(self._lock)

    def inc(self, amount: float = 1.0):
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class Gauge(Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild(self._lock)

    def set(self, value: float):
        self._default_child().set(value)

    def inc(self, amount: float = 1.0):
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0):
        self._default_child().dec(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), *, buckets=DEFAULT_BUCKETS, **kw):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket boundary")
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(f"bucket boundaries must be strictly increasing: {bounds}")
        self.buckets = bounds
        super().__init__(name, help, labelnames, **kw)

    def _new_child(self):
        return _HistogramChild(self._lock, self.buckets)

    def observe(self, value: float):
        self._default_child().observe(value)

    @property
    def count(self) -> int:
        return self._default_child().count

    @property
    def sum(self) -> float:
        return self._default_child().sum

    def quantile(self, q: float) -> float:
        """Bucket-estimated quantile of everything observed so far."""
        child = self._default_child()
        with child._lock:
            counts = list(child.counts)
        return quantile_from_buckets(self.buckets, counts, q)


class MetricsRegistry:
    """Process-local metric store + Prometheus text exposition."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self, *, max_label_sets: int = 64):
        self._lock = threading.RLock()
        self._metrics: Dict[str, Metric] = {}
        self.max_label_sets = int(max_label_sets)

    # -- get-or-create --------------------------------------------------------

    def _get_or_create(self, cls, name: str, help: str, labelnames, **kw) -> Metric:
        name = sanitize_name(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name} already registered as {m.kind}, "
                        f"not {cls.kind}"
                    )
                if tuple(labelnames) != m.labelnames:
                    raise ValueError(
                        f"metric {name} labelnames {m.labelnames} != {tuple(labelnames)}"
                    )
                return m
            m = cls(
                name, help, labelnames, max_label_sets=self.max_label_sets, **kw
            )
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames=(), *, buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames, buckets=buckets)

    # -- bulk publishing ------------------------------------------------------

    def publish(self, metrics: Mapping[str, float], help: str = ""):
        """Set one gauge per key of a flat ``metrics()`` dict (the legacy
        scrape shape) — keys are sanitized, values coerced to float."""
        for k, v in metrics.items():
            self.gauge(k, help).set(float(v))

    # -- read side ------------------------------------------------------------

    def metrics(self) -> Iterable[Metric]:
        with self._lock:
            return list(self._metrics.values())

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(sanitize_name(name))

    def value(self, name: str, labels: Optional[Mapping[str, str]] = None) -> Optional[float]:
        """Current value of a counter/gauge (None when unregistered)."""
        m = self.get(name)
        if m is None:
            return None
        child = m.labels(**labels) if labels else m._default_child()
        return child.value

    def quantile_gauges(self, quantiles: Sequence[float] = (0.5, 0.99)) -> Dict[str, float]:
        """Derived ``<hist>_p50``/``<hist>_p99``-style gauges from every
        UNLABELLED histogram's bucket counts (labelled children need
        cross-series aggregation — out of scope).  The scrape path publishes
        these each cycle so alert rules can target histogram quantiles
        directly: one observation stream, no parallel percentile state."""
        out: Dict[str, float] = {}
        for m in self.metrics():
            if not isinstance(m, Histogram) or m.labelnames:
                continue
            with m._lock:
                child = m._children.get(())
                counts = list(child.counts) if child is not None else None
            if counts is None:
                continue
            for q in quantiles:
                suffix = f"_p{round(q * 100):g}"
                out[f"{m.name}{suffix}"] = quantile_from_buckets(m.buckets, counts, q)
        return out

    def as_dict(self) -> Dict[str, float]:
        """Flat ``{exposition sample name: value}`` view of everything.
        Histograms contribute their ``_sum``/``_count`` (not the buckets)."""
        out: Dict[str, float] = {}
        for m in self.metrics():
            hist = isinstance(m, Histogram)
            for suffix, key, value in m.samples():
                if hist and suffix == "_bucket":
                    continue
                names = m.labelnames
                out[f"{m.name}{suffix}{format_labels(names, key[: len(names)])}"] = value
        return out

    def exposition(self) -> str:
        """Prometheus text format 0.0.4."""
        lines: List[str] = []
        for m in sorted(self.metrics(), key=lambda m: m.name):
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for suffix, key, value in m.samples():
                if suffix == "_bucket":
                    names = m.labelnames + ("le",)
                else:
                    names, key = m.labelnames, key[: len(m.labelnames)]
                lines.append(f"{m.name}{suffix}{format_labels(names, key)} {_fmt(value)}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-global registry (one scrape surface per process)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT
