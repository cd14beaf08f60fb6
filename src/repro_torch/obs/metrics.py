"""Thread-safe serving metrics: counters, gauges, fixed-bucket histograms
(port of ``repro.obs.metrics``: pure Python, the same names, snapshot
shape and locking).

One :class:`MetricsRegistry` instance backs a whole serving plane
(registry + scheduler(s) + router + service): every stat gets **one
name, one type, one snapshot shape**, replacing the ad-hoc per-component
``stats()`` dicts that previously each invented their own keys.

Conventions (Prometheus-compatible, so the text exposition in
:mod:`repro_torch.obs.export` is mechanical):

* metric names match ``[a-zA-Z_:][a-zA-Z0-9_:]*``; counters end in
  ``_total``; durations are in seconds and end in ``_seconds``;
* the same name may be registered repeatedly with different ``labels``
  (e.g. one ``sssp_scheduler_batches_total`` series per scheduler), but
  never with a different metric type;
* histograms use fixed, monotonically increasing upper bounds with an
  implicit ``+Inf`` bucket; p50/p90/p99 summaries are estimated by
  linear interpolation inside the target bucket (the standard
  ``histogram_quantile`` rule).

All mutation goes through one registry-level lock — serving-plane update
rates (per batch, per query) are far below contention territory, and a
single lock keeps ``snapshot()`` trivially consistent.
"""
from __future__ import annotations

import math
import re
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS", "fmt_bound",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Latency buckets (seconds): ~2.5x steps from 0.5 ms to 10 s, sized for
# the serving plane's per-batch solve latencies (the reference's buckets).
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def fmt_bound(b) -> str:
    """Canonical bucket-bound spelling ("0.1", "1", "+Inf") — shared by
    snapshot bucket keys and the exposition's ``le`` label values."""
    f = float(b)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _render_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    """Shared identity plumbing; subclasses hold the value state."""
    kind = "untyped"

    def __init__(self, name: str, help: str, labels: dict,
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.labels = dict(labels)
        self._lock = lock

    @property
    def full_name(self) -> str:
        """``name{label="value",...}`` — the snapshot/exposition key."""
        return self.name + _render_labels(self.labels)


class Counter(_Metric):
    """Monotonically increasing count (negative increments rejected)."""
    kind = "counter"

    def __init__(self, name, help, labels, lock):
        super().__init__(name, help, labels, lock)
        self._value = 0

    def inc(self, amount: int = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc({amount}))")
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value

    def _snapshot_locked(self) -> dict:
        return {"type": self.kind, "value": self._value}


class Gauge(_Metric):
    """A value that can go up and down (queue depths, occupancy)."""
    kind = "gauge"

    def __init__(self, name, help, labels, lock):
        super().__init__(name, help, labels, lock)
        self._value = 0.0

    def set(self, value) -> None:
        with self._lock:
            self._value = value

    def inc(self, amount=1) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount=1) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self):
        with self._lock:
            return self._value

    def _snapshot_locked(self) -> dict:
        return {"type": self.kind, "value": self._value}


class Histogram(_Metric):
    """Fixed-bucket histogram with interpolated percentile summaries."""
    kind = "histogram"

    def __init__(self, name, help, labels, lock,
                 buckets=DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, labels, lock)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(f"histogram {name}: buckets must be a "
                             f"non-empty increasing sequence, got {buckets}")
        self.buckets = bounds                      # finite upper bounds
        self._counts = [0] * (len(bounds) + 1)     # + the +Inf bucket
        self._count = 0
        self._sum = 0.0

    def observe(self, value) -> None:
        v = float(value)
        with self._lock:
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            self._counts[i] += 1
            self._count += 1
            self._sum += v

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def _percentile_locked(self, q: float) -> float:
        """``histogram_quantile``-style estimate from cumulative buckets."""
        if self._count == 0:
            return math.nan
        rank = q * self._count
        cum = 0
        for i, c in enumerate(self._counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c > 0:
                lo = 0.0 if i == 0 else self.buckets[i - 1]
                # the +Inf bucket has no upper bound: report its lower
                # bound (the largest finite le) rather than inventing one
                if i >= len(self.buckets):
                    return lo
                hi = self.buckets[i]
                return lo + (hi - lo) * (rank - prev_cum) / c
        return self.buckets[-1]

    def percentile(self, q: float) -> float:
        with self._lock:
            return self._percentile_locked(q)

    def _snapshot_locked(self) -> dict:
        # string bucket keys ("0.1", "1", "+Inf") keep the snapshot
        # JSON-serializable and match the exposition's le label values
        cum, cum_counts = 0, {}
        for bound, c in zip(self.buckets + (math.inf,), self._counts):
            cum += c
            cum_counts[fmt_bound(bound)] = cum
        return {
            "type": self.kind,
            "count": self._count,
            "sum": self._sum,
            "buckets": cum_counts,       # upper bound -> cumulative count
            "p50": self._percentile_locked(0.50),
            "p90": self._percentile_locked(0.90),
            "p99": self._percentile_locked(0.99),
        }


class MetricsRegistry:
    """Get-or-create registry of named metrics with one consistent lock.

    ``counter`` / ``gauge`` / ``histogram`` return the existing series
    when (name, labels) was registered before — components can therefore
    share a registry without coordinating creation order — and raise if
    the same name is reused with a different metric type.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}          # (name, labels-key) -> _Metric

    def _get_or_create(self, cls, name, help, labels, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labels = dict(labels or {})
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r} on {name}")
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            existing = self._metrics.get(key)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {cls.kind}")
                return existing
            # every series of one name must share a type
            for (n, _), m in self._metrics.items():
                if n == name and m.kind != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"not {cls.kind}")
            metric = cls(name, help, labels, self._lock, **kw)
            self._metrics[key] = metric
            return metric

    def counter(self, name, help="", labels=None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name, help="", labels=None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=None,
                  buckets=DEFAULT_LATENCY_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def metrics(self) -> list:
        """All registered series, sorted by (name, labels)."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> dict:
        """One consistent ``{full_name: {type, ...values}}`` view."""
        out = {}
        with self._lock:
            for key in sorted(self._metrics):
                m = self._metrics[key]
                entry = m._snapshot_locked()
                if m.help:
                    entry["help"] = m.help
                if m.labels:
                    entry["labels"] = dict(m.labels)
                out[m.full_name] = entry
        return out
