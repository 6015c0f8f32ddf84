"""One metrics registry — counters/gauges/histograms/EWMAs/extrema.

Before this module, three subsystems hand-rolled the same estimators:
``serve/metrics.py`` kept a min-over-quanta step estimator, ``checkpoint/
metrics.py`` a max-rate bandwidth estimator and a min-cost δ estimator,
and ``TrainLoop.run`` an inline EWMA with a 25%-drift trigger.  They now
all build on the primitives here; the public APIs of ``ServeMetrics``
and ``CheckpointMetrics`` are unchanged (the migration is internal).

The noise-robustness conventions those modules documented are encoded as
first-class metric kinds:

* :class:`Extremum` ``kind="min"`` — "the min is the noise-robust
  estimator on a shared host" (a slow sample means contention, not a
  slower machine): per-step seconds, per-checkpoint cost.
* :class:`Extremum` ``kind="max"`` — same argument for *rates*:
  measured bandwidth.
* :class:`Ewma` — drifting quantities (step time under changing load),
  with :meth:`Ewma.drift_frac` exposing the relative deviation the
  TrainLoop cadence trigger compares against its threshold.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def add(self, n: int | float = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float | None = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Extremum:
    """Running min or max; ``value`` is None until the first observation."""

    __slots__ = ("kind", "value", "count")

    def __init__(self, kind: str = "min") -> None:
        assert kind in ("min", "max"), kind
        self.kind = kind
        self.value: float | None = None
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        if self.value is None:
            self.value = v
        elif self.kind == "min":
            self.value = min(self.value, v)
        else:
            self.value = max(self.value, v)

    def reset(self) -> None:
        self.value = None
        self.count = 0


class Ewma:
    """Exponentially-weighted moving average, seeded by the first sample
    (``v = alpha*v + (1-alpha)*x`` thereafter) — the exact recurrence the
    TrainLoop hand-rolled, factored out so serve/ckpt/calibration share
    it."""

    __slots__ = ("alpha", "value", "count")

    def __init__(self, alpha: float = 0.9) -> None:
        self.alpha = float(alpha)
        self.value: float | None = None
        self.count = 0

    def update(self, x: float) -> float:
        x = float(x)
        self.count += 1
        if self.value is None:
            self.value = x
        else:
            self.value = self.alpha * self.value + (1 - self.alpha) * x
        return self.value

    def drift_frac(self, baseline: float | None) -> float:
        """|ewma - baseline| / baseline — the relative drift the managed
        re-resolution triggers threshold on.  inf when there is no
        baseline yet (so 'no baseline' always trips a trigger)."""
        if self.value is None:
            return 0.0
        if baseline is None or baseline <= 0:
            return math.inf
        return abs(self.value - baseline) / baseline

    def reset(self) -> None:
        self.value = None
        self.count = 0


class Histogram:
    """Reservoir of the most recent ``window`` observations with running
    count/sum (the running aggregates never forget; percentiles are over
    the window)."""

    __slots__ = ("window", "samples", "count", "sum")

    def __init__(self, window: int = 4096) -> None:
        self.window = int(window)
        self.samples: deque[float] = deque(maxlen=self.window)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.samples.append(v)
        self.count += 1
        self.sum += v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the window (p in [0, 1])."""
        xs = sorted(self.samples)
        if not xs:
            return 0.0
        idx = min(len(xs) - 1, max(0, math.ceil(p * len(xs)) - 1))
        return xs[idx]

    @property
    def median(self) -> float:
        return self.percentile(0.5)


@dataclasses.dataclass
class MetricsRegistry:
    """Get-or-create registry keyed by metric name.  Re-requesting a name
    returns the same object (and asserts the kind matches — a name that
    is a counter in one module and a gauge in another is a bug)."""

    metrics: dict[str, Any] = dataclasses.field(default_factory=dict)

    def _get(self, name: str, factory, kind) -> Any:
        m = self.metrics.get(name)
        if m is None:
            m = factory()
            self.metrics[name] = m
        assert isinstance(m, kind), (
            f"metric {name!r} already registered as "
            f"{type(m).__name__}, requested {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, Gauge)

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        return self._get(name, lambda: Histogram(window), Histogram)

    def ewma(self, name: str, alpha: float = 0.9) -> Ewma:
        return self._get(name, lambda: Ewma(alpha), Ewma)

    def extremum(self, name: str, kind: str = "min") -> Extremum:
        return self._get(name, lambda: Extremum(kind), Extremum)

    def snapshot(self) -> dict[str, Any]:
        """Plain-data view for export (`otherData.metrics` in the Chrome
        trace)."""
        out: dict[str, Any] = {}
        for name, m in sorted(self.metrics.items()):
            if isinstance(m, Counter):
                out[name] = m.value
            elif isinstance(m, Gauge):
                out[name] = m.value
            elif isinstance(m, Extremum):
                out[name] = {"kind": m.kind, "value": m.value,
                             "count": m.count}
            elif isinstance(m, Ewma):
                out[name] = {"ewma": m.value, "count": m.count,
                             "alpha": m.alpha}
            elif isinstance(m, Histogram):
                out[name] = {"count": m.count, "mean": m.mean,
                             "p50": m.median, "p99": m.percentile(0.99)}
        return out
