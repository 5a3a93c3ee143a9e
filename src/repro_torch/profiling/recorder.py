"""Record-level profiler (paper §5.2); a copy of
``repro.profiling.recorder``.

The paper modifies Hadoop to time the processing of *records* rather than
sub-phases, grouping records into units (empirically 5 records/unit) to keep
profiling overhead ~5% instead of Starfish's 10-50%.  Here a "record" is one
profiled work unit of the framework — a microbatch step, a decode-step batch,
or a data-pipeline fetch — and the same unit-grouping knob applies.

Also provides sub-phase timing ("spill"-analogue phases: data fetch,
checkpoint write) so the Fig. 3 constancy benchmark can contrast them with
record times.

Both timers are thin shims over ``repro_torch.obs.trace.timed`` — one clock
source for the whole repo.  Pass ``tracer=`` and every record / phase also
lands in the trace as a ``record.<name>`` / ``phase.<name>`` span; without
a tracer the stopwatch path is allocation-free and nothing else changes.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Callable, Dict, List

import numpy as np

from ..obs.trace import timed as _timed

__all__ = ["RecordProfiler", "PhaseTimer"]


class RecordProfiler:
    """Accumulates per-record wall times, grouped in units of ``unit`` records.

    Usage::

        prof = RecordProfiler(unit=5)
        for batch in stream:
            with prof.record():
                out = step(batch)            # must block: on CUDA, end the
                torch.cuda.synchronize()     # record with a device sync
        times = prof.unit_times()            # seconds per unit, np.float64
    """

    def __init__(self, unit: int = 5, name: str = "task", tracer=None):
        if unit < 1:
            raise ValueError("unit must be >= 1")
        self.unit = unit
        self.name = name
        self.tracer = tracer
        self._raw_ns: List[int] = []

    @contextlib.contextmanager
    def record(self):
        sw = _timed(self.tracer, "record." + self.name)
        try:
            with sw:
                yield
        finally:
            # sw.dur is set by __exit__ (before this finally runs), so a
            # record is kept even when the timed body raises — same contract
            # as the old perf_counter_ns try/finally.
            self._raw_ns.append(int(sw.dur * 1e9))

    def wrap(self, fn: Callable) -> Callable:
        """Return fn wrapped so every call is timed as one record."""

        def timed(*args, **kwargs):
            with self.record():
                return fn(*args, **kwargs)

        return timed

    @property
    def num_records(self) -> int:
        return len(self._raw_ns)

    def record_times(self) -> np.ndarray:
        """Raw per-record seconds."""
        return np.asarray(self._raw_ns, dtype=np.float64) * 1e-9

    def unit_times(self, start: int = 0) -> np.ndarray:
        """Per-unit seconds: consecutive groups of ``unit`` records summed
        (the paper's cost/accuracy balance). Trailing partial unit dropped.

        ``start`` skips the first ``start`` units, touching only the newer
        records — O(new units), so a live consumer polling for freshly
        completed units inside a hot loop pays for the delta, not the run.
        """
        m = (len(self._raw_ns) // self.unit) * self.unit
        lo = int(start) * self.unit
        if lo >= m:
            return np.zeros((0,), np.float64)
        raw = np.asarray(self._raw_ns[lo:m], dtype=np.float64) * 1e-9
        return raw.reshape(-1, self.unit).sum(axis=1)

    def total(self) -> float:
        return float(self.record_times().sum())

    def reset(self) -> None:
        self._raw_ns.clear()


class PhaseTimer:
    """Sub-phase wall times keyed by name (read-map / spill / merge analogue)."""

    def __init__(self, tracer=None):
        self.tracer = tracer
        self._ns: Dict[str, List[int]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        sw = _timed(self.tracer, "phase." + name)
        try:
            with sw:
                yield
        finally:
            self._ns[name].append(int(sw.dur * 1e9))

    def times(self, name: str) -> np.ndarray:
        return np.asarray(self._ns.get(name, ()), dtype=np.float64) * 1e-9

    def totals(self) -> Dict[str, float]:
        return {k: float(np.sum(v) * 1e-9) for k, v in self._ns.items()}

    def names(self):
        return list(self._ns)
