"""Zero-dependency span tracer — the fleet's one timing seam.

Every layer of the estimation stack (engine dispatch, stream drain/commit/
collect, mux plan/coalesce/dispatch/commit, shard fan-out, transport round
trips) times itself through this module, so "where does a tick's time go?"
has exactly one answer and one clock.  Design constraints, in order:

- **Cheap when disabled.**  Instrumented call sites never branch on a
  feature flag; they call ``span(tracer, name, ...)`` with ``tracer=None``
  and get back a shared no-op context manager (``_NULL``) — no allocation,
  no clock read.  The disabled cost per call site is a function call and a
  kwargs dict; ``benchmarks/fleet_obs.py`` prices it and the results schema
  pins the bound.
- **Injectable monotonic clock.**  ``Tracer(clock=...)`` takes any
  zero-arg float-seconds callable (default ``time.perf_counter``), so the
  deterministic suites drive span trees off a counting fake and assert
  exact timestamps.  Everything that needs a duration *even when tracing is
  off* (``ShardAccount.elapsed_s``, ``launch.serve``'s ``vet_s``) goes
  through ``timed(tracer, ...)`` — the tracer's clock when present, the
  same ``perf_counter`` otherwise — so there is one clock source, not a
  tracer clock plus ad-hoc ``perf_counter`` pairs that could disagree.
- **Cross-process reassembly.**  Spans are plain ``SpanRecord`` NamedTuples
  (pickle-safe), so a transport shard worker drains its tracer into the
  ``TickReply`` and the driver ``adopt``s the records under the worker's
  ``pid`` lane, time-shifted into the driver's round-trip window — one
  Chrome trace spanning every process (``repro.obs.export``).

Lanes: ``pid`` is the process (0 = driver, shard ``k``'s worker = ``k+1``);
``tid`` is the within-process lane (shard index for in-process shard muxes,
0 otherwise).  Nesting is tracked per ``tid`` via an explicit stack, so a
record carries its parent span id and exporters need no containment
inference.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

__all__ = ["SpanRecord", "Tracer", "span", "timed"]


class SpanRecord(NamedTuple):
    """One completed span.  ``ts``/``dur`` are seconds on the tracer clock;
    ``sid`` is unique per tracer, ``parent`` the enclosing span's ``sid``
    on the same ``tid`` (``None`` at the top level); ``attrs`` is a sorted
    tuple of pickle-safe ``(key, value)`` pairs."""

    name: str
    ts: float
    dur: float
    pid: int
    tid: int
    sid: int
    parent: Optional[int]
    attrs: tuple


class _NullSpan:
    """The shared disabled-path context manager: no clock, no allocation.
    ``dur`` stays 0.0 — consumers that need a real duration with tracing
    off use ``timed`` instead."""

    __slots__ = ()
    dur = 0.0
    sid = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


_NULL = _NullSpan()


class _Stopwatch:
    """``timed``'s fallback when no tracer is wired: same ``.dur`` surface,
    same monotonic clock family, nothing recorded."""

    __slots__ = ("dur", "_t0")

    def __enter__(self) -> "_Stopwatch":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.dur = time.perf_counter() - self._t0
        return False

    def set(self, **attrs) -> "_Stopwatch":
        return self


class _Span:
    """One live span (context manager).  ``dur`` is valid after ``__exit__``
    — call sites that fold span time into their own accounting
    (``elapsed_s``, ``vet_s``) read it instead of re-timing."""

    __slots__ = ("_tracer", "name", "tid", "_attrs", "sid", "parent",
                 "_t0", "dur")

    def __init__(self, tracer: "Tracer", name: str, tid: int, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.tid = tid
        self._attrs = attrs
        self.sid = -1
        self.parent: Optional[int] = None
        self.dur = 0.0

    def set(self, **attrs) -> "_Span":
        """Attach attributes discovered mid-span (row counts, cache hits)."""
        self._attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        tr = self._tracer
        self.sid = tr._next_sid
        tr._next_sid += 1
        stack = tr._stacks.get(self.tid)
        if stack is None:
            stack = tr._stacks[self.tid] = []
        self.parent = stack[-1].sid if stack else None
        stack.append(self)
        self._t0 = tr.clock()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        self.dur = tr.clock() - self._t0
        stack = tr._stacks[self.tid]
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # tolerate out-of-order exits, never corrupt
            stack.remove(self)
        tr._record(SpanRecord(self.name, self._t0, self.dur, tr.pid,
                              self.tid, self.sid, self.parent,
                              tuple(sorted(self._attrs.items()))))
        return False


class Tracer:
    """Collects nested ``SpanRecord``s from every instrumented layer.

    Args:
        clock: zero-arg monotonic float-seconds callable (injectable for
            deterministic tests; default ``time.perf_counter``).
        pid: process lane for spans recorded *by this tracer* (adopted
            records keep the lane given to ``adopt``).
        metrics: optional ``repro.obs.MetricsRegistry``; when set, every
            completed span feeds ``span.<name>`` (duration histogram,
            seconds) and ``span.<name>.count`` automatically, so metrics
            ride the same seam as spans.

    Example::

        >>> clk = iter(range(100)).__next__
        >>> tr = Tracer(clock=lambda: float(clk()))
        >>> with tr.span("tick"):
        ...     with tr.span("dispatch", rows=3):
        ...         pass
        >>> [(r.name, r.ts, r.dur, r.parent) for r in tr.records]
        [('dispatch', 1.0, 1.0, 0), ('tick', 0.0, 3.0, None)]
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter, *,
                 pid: int = 0, metrics=None):
        self.clock = clock
        self.pid = int(pid)
        self.metrics = metrics
        self.records: List[SpanRecord] = []  # completion order
        self.process_names: Dict[int, str] = {self.pid: "driver"}
        self._stacks: Dict[int, List[_Span]] = {}
        self._next_sid = 0

    def __repr__(self) -> str:
        return (f"Tracer(pid={self.pid}, records={len(self.records)}, "
                f"open={sum(len(s) for s in self._stacks.values())})")

    def span(self, name: str, tid: int = 0, **attrs) -> _Span:
        """A new span context manager on lane ``tid`` (not yet entered)."""
        return _Span(self, name, int(tid), attrs)

    def now(self) -> float:
        """Current tracer-clock time (for aligning adopted records)."""
        return self.clock()

    def _record(self, rec: SpanRecord) -> None:
        self.records.append(rec)
        if self.metrics is not None:
            self.metrics.histogram("span." + rec.name).observe(rec.dur)

    # -------------------------------------------------------- reassembly
    def drain(self) -> List[SpanRecord]:
        """Return and clear the completed records (open spans keep running
        and will land in a later drain).  The transport worker calls this
        per tick to ship its spans back on the ``TickReply``."""
        out, self.records = self.records, []
        return out

    def clear(self) -> None:
        self.records.clear()

    def adopt(self, records: Iterable, *, pid: int,
              at: Optional[float] = None, name: Optional[str] = None) -> int:
        """Splice records drained from *another* tracer (typically another
        process) into this one under process lane ``pid``.

        Span ids are remapped into this tracer's id space (parent links
        preserved), and — because the source process's monotonic clock has
        its own origin — timestamps are uniformly shifted so the earliest
        adopted record lands at ``at`` (driver-side round-trip start;
        ``None`` keeps the source timestamps).  Relative timing within the
        adopted batch is exact; absolute alignment across processes is as
        good as the anchor.  ``name`` labels the process lane in exports.

        Returns the number of records adopted.
        """
        records = [SpanRecord(*r) for r in records]
        if not records:
            return 0
        if name is not None:
            self.process_names[int(pid)] = name
        base = self._next_sid
        self._next_sid = base + max(r.sid for r in records) + 1
        shift = 0.0 if at is None else at - min(r.ts for r in records)
        for r in records:
            self._record(r._replace(
                ts=r.ts + shift, pid=int(pid), sid=base + r.sid,
                parent=None if r.parent is None else base + r.parent))
        return len(records)


def span(tracer: Optional[Tracer], name: str, tid: int = 0, **attrs):
    """The instrumentation-seam entry point: a tracer span when tracing is
    on, the shared no-op context manager when ``tracer`` is ``None``.
    Call sites never branch themselves — the disabled path costs one call.
    """
    if tracer is None:
        return _NULL
    return tracer.span(name, tid=tid, **attrs)


def timed(tracer: Optional[Tracer], name: str, tid: int = 0, **attrs):
    """Like ``span`` but *always* measures: ``.dur`` is a real duration
    after exit even with ``tracer=None`` (a plain stopwatch on the same
    monotonic clock family).  This is the one clock source for bookkeeping
    that must exist regardless of tracing — ``ShardAccount.elapsed_s``,
    ``launch.serve``'s ``vet_s`` — so enabling tracing changes what is
    *recorded*, never what is *measured*.
    """
    if tracer is None:
        return _Stopwatch()
    return tracer.span(name, tid=tid, **attrs)
