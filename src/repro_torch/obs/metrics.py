"""Zero-dependency metrics: counters, gauges, fixed-bucket histograms.

A copy of ``repro.obs.metrics`` (pure Python).

The fleet's second observability surface, next to spans
(``repro_torch.obs.trace``).
Spans answer "where did this tick's time go"; metrics answer "what has the
fleet done so far" — dispatch counts, staged bytes, retry totals, span
duration distributions — as monotonically growing state that is cheap to
update on every event and cheap to snapshot for a dashboard or benchmark
artifact.

Everything here is plain Python over dicts and lists: no client libraries,
no background threads, no global registry.  A ``MetricsRegistry`` is an
ordinary object you construct, hand to a ``Tracer`` (which then feeds
``span.<name>`` duration histograms automatically), and ``snapshot()`` into
a JSON-ready dict.

Histograms use *fixed* upper-bound buckets chosen at construction (plus an
implicit ``+inf``), so observation is O(#buckets) worst-case with no
allocation, and two snapshots are comparable bucket-for-bucket.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS"]

# Log-spaced seconds, 1us .. 10s — wide enough for a null span and a cold
# pallas compile in the same histogram.
DEFAULT_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)


class Counter:
    """Monotonically increasing count (dispatches, retries, bytes)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, by: float = 1) -> None:
        if by < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc by {by})")
        self.value += by

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """A value that goes up and down (live streams, ring occupancy)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value

    def inc(self, by: float = 1) -> None:
        self.value += by

    def dec(self, by: float = 1) -> None:
        self.value -= by

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram with running count/sum/min/max.

    ``bounds`` are inclusive upper bounds; an implicit ``+inf`` bucket
    catches the tail, so ``sum(counts) == count`` always.
    """

    __slots__ = ("name", "bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str,
                 bounds: Sequence[float] = DEFAULT_BUCKETS):
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram {name!r} bounds must be strictly "
                             f"increasing, got {bounds!r}")
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.count += 1
        self.sum += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {"type": "histogram", "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "buckets": dict(zip([f"le_{b:g}" for b in self.bounds]
                                    + ["le_inf"], self.counts))}


class MetricsRegistry:
    """Named metric store with get-or-create accessors.

    Accessors are idempotent per name — the first call creates, later
    calls return the same object — but a name cannot change kind::

        >>> reg = MetricsRegistry()
        >>> reg.counter("engine.dispatches").inc()
        >>> reg.counter("engine.dispatches").inc(2)
        >>> reg.counter("engine.dispatches").value
        3
        >>> reg.gauge("fleet.streams").set(9)
        >>> h = reg.histogram("tick.s", bounds=(0.01, 0.1))
        >>> h.observe(0.05); h.count
        1
        >>> sorted(reg.snapshot())
        ['engine.dispatches', 'fleet.streams', 'tick.s']
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, *args, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, bounds)

    def snapshot(self) -> Dict[str, dict]:
        """JSON-ready ``{name: {type, ...}}`` dict, insertion-ordered."""
        return {name: m.snapshot() for name, m in self._metrics.items()}
