"""VetMux: coalesce many live streams into shared batched engine dispatches.

The port of ``repro_torch.fleet.mux``; its ``state_dict`` format is the
reference's, key for key, so either package can continue a fleet the other
checkpointed.

One live consumer = one ``VetStream``; a fleet of N consumers ticked one at a
time pays N separate engine dispatches per decision — the O(workers) Python
loop that caps a controller at a few dozen workers.  The mux replaces the
loop with a three-phase tick over every registered stream:

1. **Plan** (``repro_torch.fleet.schedule``): pending window counts, priorities,
   staleness and ring headroom go through the tick planner, which orders the
   fleet, applies per-tenant fairness quotas, serves overrun-risk streams
   first, and defers whatever exceeds the tick ``budget``.
2. **Drain + coalesce**: each serviced stream's delta (``VetStream.drain``)
   is grouped with every other delta of the same window length into a shape
   bucket; each bucket's matrices concatenate into one (rows, window) batch,
   padded to the next power of two rows so launch shapes stay O(log fleet)
   instead of one per distinct row count.
3. **Dispatch + commit**: one ``VetEngine`` call per shape bucket — a
   homogeneous 1024-worker fleet is *one* batched call per tick — and each
   stream commits its slice of the result (``VetStream.commit``).  Rows are
   bitwise what the stream's own ``tick()`` would have computed on the numpy
   backend (row-independent scalar loop) and within the standing 1e-5
   differential contract on torch/cuda (batch rows are independent), so the
   per-stream oracle equality is preserved — locked by
   ``tests/test_fleet.py`` across the scenario bank.

Caching composes: each coalesced dispatch is memoized in the engine's result
cache under the tuple of its member deltas' content-pure keys, so replaying
the same fleet into the same engine serves whole mux ticks from cache without
hashing a single matrix.

``feed`` mirrors ``VetStream.feed`` but under ring pressure triggers a *mux*
tick (coalesced) instead of a per-stream one, so even overrun protection
never degenerates into scalar dispatches.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Hashable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from ..engine import BatchVetResult, VetEngine, VetStream, default_engine
from ..engine.stream import RingDelta, StreamDelta
from ..obs.trace import span as _span
from .anomaly import AnomalyMonitor, RegimeShift, default_monitor
from .schedule import StreamRequest, TickPlan, plan_tick

__all__ = ["MuxStats", "MuxTick", "VetMux"]


class MuxStats(NamedTuple):
    """Lifetime counters for one mux (``VetMux.stats``).

    ``retries``/``respawns`` are transport accounting
    (the transport layer, not ported yet): an in-process mux never retries
    or respawns anything, so they default to 0 and only the cross-process
    driver reports non-zero values.  ``anomalies`` counts regime-shift
    flags raised by the anomaly monitor (0 when monitoring is off).
    """

    ticks: int  # mux ticks
    dispatches: int  # coalesced engine dispatches issued
    rows: int  # window rows committed across all streams
    padded_rows: int  # pow2-padding overhead rows ever dispatched
    deferred: int  # window-row deferrals (sum over ticks)
    streams: int  # currently registered streams
    retries: int = 0  # transport round trips re-attempted after a failure
    respawns: int = 0  # shard worker processes restarted after a crash
    anomalies: int = 0  # regime-shift flags raised (repro_torch.fleet.anomaly)


def _flush_loop(tick_fn, max_ticks: int):
    """Shared flush driver for every mux variant (``VetMux``,
    ``ShardedVetMux``, ``TransportVetMux``): tick until nothing is
    deferred, performing **at most** ``max_ticks`` ticks total — the
    initial tick included.  The variants used to decrement their own
    ``max_ticks`` argument around the loop and disagreed about whether the
    pre-loop tick counted; one helper, one boundary.

    Raises:
        ValueError: ``max_ticks < 1`` (a flush always ticks at least once).
        RuntimeError: backlog still deferred after ``max_ticks`` ticks.
    """
    max_ticks = int(max_ticks)
    if max_ticks < 1:
        raise ValueError(f"flush needs max_ticks >= 1, got {max_ticks}")
    tick = tick_fn()
    done = 1
    while tick.deferred:
        if done >= max_ticks:
            raise RuntimeError(
                f"flush did not converge within {max_ticks} ticks — is new "
                f"work arriving concurrently?")
        tick = tick_fn()
        done += 1
    return tick


class MuxTick(NamedTuple):
    """One mux tick's outcome.

    ``results[sid]`` is the stream's retained-window result (same object
    contract as ``VetStream.tick()``: ``None`` until the first window
    completes, the previous object when nothing changed).  ``flags`` holds
    the regime shifts the anomaly monitor raised *this tick* (empty when
    monitoring is off or the fleet is steady).
    """

    results: Dict[Hashable, Optional[BatchVetResult]]
    serviced: Dict[Hashable, int]  # stream -> window rows dispatched this tick
    deferred: Dict[Hashable, int]  # stream -> pending rows pushed to later ticks
    urgent: Tuple[Hashable, ...]  # streams served out-of-budget (overrun risk)
    dispatches: int  # engine dispatches this tick (== shape buckets hit)
    rows: int  # window rows committed this tick
    padded_rows: int  # pow2-padding overhead rows this tick
    flags: Tuple[RegimeShift, ...] = ()  # regime shifts raised this tick

    @property
    def vet_job(self) -> float:
        """Fleet-level vet_job: mean of every stream's newest window vet
        (paper §4.4 across the live fleet)."""
        newest = [float(r.vet[-1]) for r in self.results.values()
                  if r is not None and r.workers > 0]
        if not newest:
            raise ValueError("no stream has a complete window yet")
        return float(np.mean(newest))


class _Member:
    """Registration record for one stream."""

    __slots__ = ("stream", "priority", "tenant", "staleness")

    def __init__(self, stream: VetStream, priority: float, tenant: str):
        self.stream = stream
        self.priority = priority
        self.tenant = tenant
        self.staleness = 0


class VetMux:
    """Cross-stream vet multiplexer over one shared ``VetEngine``.

    Usage::

        mux = VetMux(engine, budget=256)
        for wid in workers:
            mux.register(wid, window=200, stride=100)
        while serving:
            for wid, chunk in arrivals:
                mux.feed(wid, chunk)
            tick = mux.tick()              # one dispatch per window-length
            dashboard.update(tick.vet_job, tick.results)

    ``budget`` caps window rows vetted per tick (``None`` = unbounded);
    ``tenant_weights`` biases the fairness split (default: equal);
    ``urgent_headroom`` is the ring headroom at or below which a stream is
    served in full regardless of budget (see ``repro_torch.fleet.schedule``);
    ``monitor`` is the anomaly monitor — ``True`` (default) builds one
    matched to the engine backend, ``False``/``None`` disables monitoring,
    or pass a configured ``repro_torch.fleet.AnomalyMonitor``.
    """

    def __init__(self, engine: Optional[VetEngine] = None, *,
                 budget: Optional[int] = None,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 urgent_headroom: int = 0,
                 monitor=True,
                 tracer=None):
        self.engine = engine if engine is not None else default_engine("cuda")
        if budget is not None:
            budget = int(budget)
            if budget < 1:
                raise ValueError(f"budget must be >= 1 window row, got {budget}")
        self.budget = budget
        self.tenant_weights = dict(tenant_weights or {})
        self.urgent_headroom = int(urgent_headroom)
        if monitor is True:
            monitor = default_monitor(self.engine.backend,
                                      self.engine._device_arg)
        elif not monitor:
            monitor = None
        self.monitor: Optional[AnomalyMonitor] = monitor
        # Observability seam (repro_torch.obs).  Only a non-None tracer is wired
        # through: attaching goes down to the engine, and the (possibly
        # process-wide default_engine) must not lose a tracer some other
        # consumer attached just because an untraced mux was built on it.
        self.tracer = None
        self.trace_tid = 0
        if tracer is not None:
            self.set_tracer(tracer)
        self._members: "OrderedDict[Hashable, _Member]" = OrderedDict()
        self._ticks = 0
        self._dispatches = 0
        self._rows = 0
        self._padded_rows = 0
        self._deferred = 0

    def __repr__(self) -> str:
        return (f"VetMux(backend={self.engine.backend!r}, "
                f"streams={len(self._members)}, budget={self.budget}, "
                f"ticks={self._ticks})")

    def set_tracer(self, tracer, tid: int = 0) -> None:
        """Attach (or detach, with ``None``) a ``repro_torch.obs.Tracer``.  Spans
        from this mux — and from its engine and every stream it drains —
        land on lane ``tid`` (the shard index in a sharded fleet)."""
        self.tracer = tracer
        self.trace_tid = int(tid)
        self.engine.set_tracer(tracer, tid=tid)

    # -------------------------------------------------------- registration
    def register(self, stream_id: Hashable, *, window: Optional[int] = None,
                 stride: int = 1, capacity: Optional[int] = None,
                 history: Optional[int] = None, priority: float = 0.0,
                 tenant: str = "default",
                 stream: Optional[VetStream] = None) -> VetStream:
        """Add a stream to the fleet; returns the (created) ``VetStream``.

        Either pass the window geometry (``window``/``stride``/``capacity``/
        ``history``) and let the mux create the stream on its engine, or pass
        an existing ``stream`` — which must already be bound to the mux's
        engine, because coalesced dispatches run on exactly one engine.

        Args:
            stream_id: any hashable fleet-unique id.
            window / stride / capacity / history: ``VetStream`` geometry
                (used only when ``stream`` is not given).
            priority / tenant: planner inputs (see ``repro_torch.fleet.schedule``).
            stream: an existing stream to attach instead.

        Returns:
            The registered ``VetStream``.

        Raises:
            ValueError: duplicate id, missing ``window`` and ``stream``, or
                an attached stream bound to a different engine.

        Example::

            >>> mux = VetMux(VetEngine("numpy", buckets=64))
            >>> st = mux.register("w0", window=8, stride=4)
            >>> st.window, len(mux), "w0" in mux
            (8, 1, True)
        """
        if stream_id in self._members:
            raise ValueError(f"stream {stream_id!r} is already registered")
        if stream is None:
            if window is None:
                raise ValueError(
                    "register needs window= (to create the stream) or "
                    "stream= (to attach an existing one)")
            stream = VetStream(self.engine, window=window, stride=stride,
                               capacity=capacity, history=history)
        elif stream.engine is not self.engine:
            raise ValueError(
                "attached stream must share the mux engine (coalesced "
                "dispatches run on one engine); build it with "
                "VetStream(mux.engine, ...)")
        self._members[stream_id] = _Member(stream, float(priority),
                                           str(tenant))
        return stream

    def deregister(self, stream_id: Hashable) -> VetStream:
        """Remove a stream (fleet churn); returns it for the caller to keep
        using standalone — its retained rows and vetted watermark survive.

        Raises:
            KeyError: unknown ``stream_id``.

        Example::

            >>> mux = VetMux(VetEngine("numpy", buckets=64))
            >>> st = mux.register("w0", window=8, stride=4)
            >>> mux.deregister("w0") is st and len(mux) == 0
            True
        """
        member = self._members.pop(self._require(stream_id))
        if self.monitor is not None:
            self.monitor.forget(stream_id)
        return member.stream

    def _require(self, stream_id: Hashable) -> Hashable:
        if stream_id not in self._members:
            raise KeyError(f"stream {stream_id!r} is not registered "
                           f"({len(self._members)} streams live)")
        return stream_id

    def stream(self, stream_id: Hashable) -> VetStream:
        return self._members[self._require(stream_id)].stream

    def ids(self) -> Iterator[Hashable]:
        return iter(self._members)

    def __contains__(self, stream_id: Hashable) -> bool:
        return stream_id in self._members

    def __len__(self) -> int:
        return len(self._members)

    @property
    def stats(self) -> MuxStats:
        return MuxStats(ticks=self._ticks, dispatches=self._dispatches,
                        rows=self._rows, padded_rows=self._padded_rows,
                        deferred=self._deferred, streams=len(self._members),
                        anomalies=(self.monitor.raised
                                   if self.monitor is not None else 0))

    # ------------------------------------------------------------- ingest
    def feed(self, stream_id: Hashable, times) -> int:
        """Append a chunk to one stream, mux-ticking only under ring pressure.

        The fleet analogue of ``VetStream.feed``: when the stream's append
        budget is exhausted, the *whole mux* ticks (one coalesced dispatch
        set — every stream with pending windows benefits) instead of the
        stream paying a private scalar-sized dispatch.

        Args:
            stream_id: a registered stream.
            times: 1-D chunk of record times, arbitrarily large.

        Returns:
            Number of records appended.

        Raises:
            KeyError: unknown ``stream_id``.

        Example::

            >>> mux = VetMux(VetEngine("numpy", buckets=64))
            >>> _ = mux.register("w0", window=8, stride=4, capacity=16)
            >>> mux.feed("w0", np.linspace(1e-3, 2e-3, 100))  # 6x the ring
            100
        """
        return self.stream(stream_id).feed(times, on_pressure=self.tick)

    # -------------------------------------------------------------- tick
    def tick(self) -> MuxTick:
        """Drain every stream's newly complete windows through shared
        batched dispatches; see the module docstring for the three phases.

        Returns:
            The merged ``MuxTick``: per-stream retained results, service /
            deferral maps, and this tick's dispatch/row counters.

        Example::

            >>> mux = VetMux(VetEngine("numpy", buckets=64))
            >>> for sid in ("a", "b"):
            ...     _ = mux.register(sid, window=8, stride=4)
            ...     _ = mux.feed(sid, np.linspace(1e-3, 2e-3, 16))
            >>> t = mux.tick()
            >>> (t.rows, t.dispatches)     # 2 streams, ONE shared dispatch
            (6, 1)
            >>> t.results["a"].workers, t.vet_job >= 1.0
            (3, True)
        """
        self._ticks += 1
        tick_span = _span(self.tracer, "mux.tick", tid=self.trace_tid,
                          streams=len(self._members))
        with tick_span:
            with _span(self.tracer, "mux.plan", tid=self.trace_tid):
                requests = [
                    StreamRequest(stream_id=sid,
                                  pending=m.stream.pending_windows,
                                  priority=m.priority, tenant=m.tenant,
                                  staleness=m.staleness,
                                  headroom=m.stream.headroom)
                    for sid, m in self._members.items()
                ]
                plan = plan_tick(requests, budget=self.budget,
                                 tenant_weights=self.tenant_weights,
                                 urgent_headroom=self.urgent_headroom)

            dispatches = rows = padded = 0
            serviced: Dict[Hashable, int] = {}

            # Fused path: when the engine's block-sparse kernel covers every
            # window length planned for service, the whole ragged tick is ONE
            # launch — the per-length shape buckets below collapse into a
            # single concatenated arena with a row -> (stream, window) map.
            fused = bool(plan.serve) and self.engine.fused_supported(
                max(self._members[sid].stream.window for sid in plan.serve))
            if fused:
                with _span(self.tracer, "mux.coalesce", tid=self.trace_tid,
                           fused=True) as co:
                    ring: List[Tuple[Hashable, RingDelta]] = []
                    for sid, take in plan.serve.items():
                        delta = self._members[sid].stream.drain_ring(
                            max_windows=take)
                        if delta is not None:
                            ring.append((sid, delta))
                    if ring:
                        offsets = np.cumsum(
                            [0] + [d.arena.size for _, d in ring[:-1]])
                        arena = np.concatenate([d.arena for _, d in ring])
                        starts = np.concatenate(
                            [d.starts + off
                             for (_, d), off in zip(ring, offsets)])
                        lengths = np.concatenate(
                            [np.full(d.count, d.window, dtype=np.int64)
                             for _, d in ring])
                    co.set(streams=len(ring))
                if ring:
                    key = ("muxfused", tuple(d.key for _, d in ring))
                    with _span(self.tracer, "mux.dispatch",
                               tid=self.trace_tid, fused=True,
                               rows=int(starts.size)):
                        res = self.engine._memo(
                            key, lambda: self.engine._vet_arena_impl(
                                arena, starts, lengths))
                    dispatches += 1
                    with _span(self.tracer, "mux.commit",
                               tid=self.trace_tid, streams=len(ring)):
                        off = 0
                        for sid, delta in ring:
                            seg = BatchVetResult(
                                *(a[off:off + delta.count] for a in res))
                            self._members[sid].stream.commit(delta, seg)
                            serviced[sid] = delta.count
                            off += delta.count
                            rows += delta.count

            # Drain in plan order, bucket by window length (the matrix column
            # count) — heterogeneous fleets dispatch once per distinct length.
            buckets: "OrderedDict[int, List[Tuple[Hashable, StreamDelta]]]" \
                = OrderedDict()
            if not fused:
                with _span(self.tracer, "mux.coalesce", tid=self.trace_tid,
                           fused=False):
                    for sid, take in plan.serve.items():
                        delta = self._members[sid].stream.drain(
                            max_windows=take)
                        if delta is not None:
                            buckets.setdefault(
                                delta.matrix.shape[1], []).append(
                                    (sid, delta))

            for wlen, group in buckets.items():
                big = (group[0][1].matrix if len(group) == 1
                       else np.concatenate([d.matrix for _, d in group]))
                # Same pow2 padding contract as VetStream.tick: batch
                # shapes stay O(log fleet) as deltas fluctuate tick to tick.
                big, pad_rows = self.engine.pad_rows_pow2(big)
                padded += pad_rows
                key = ("mux", wlen, tuple(d.key for _, d in group))
                with _span(self.tracer, "mux.dispatch", tid=self.trace_tid,
                           wlen=int(wlen), rows=int(big.shape[0])):
                    res = self.engine._memo(
                        key, lambda big=big: self.engine._vet_batch_impl(big))
                dispatches += 1
                with _span(self.tracer, "mux.commit", tid=self.trace_tid,
                           streams=len(group)):
                    off = 0
                    for sid, delta in group:
                        seg = BatchVetResult(
                            *(a[off:off + delta.count] for a in res))
                        self._members[sid].stream.commit(delta, seg)
                        serviced[sid] = delta.count
                        off += delta.count
                        rows += delta.count

            results: Dict[Hashable, Optional[BatchVetResult]] = {}
            deferred: Dict[Hashable, int] = {}
            flags: List[RegimeShift] = []
            with _span(self.tracer, "mux.collect", tid=self.trace_tid):
                for sid, m in self._members.items():
                    results[sid] = m.stream.collect()
                    left = m.stream.pending_windows
                    if left > 0:
                        deferred[sid] = left
                    # Staleness counts ticks since the stream last received
                    # *any* service while waiting; a partially served stream
                    # is not starving (fairness already gave its tenant a
                    # share), so only fully passed-over streams age.
                    if sid in serviced:
                        m.staleness = 0
                    elif left > 0:
                        m.staleness += 1
            if self.monitor is not None:
                # Same observe order as the collect loop (registration
                # order), so flags are identical to the pre-split single
                # loop — only the span boundary separates the phases.
                with _span(self.tracer, "mux.anomaly", tid=self.trace_tid):
                    for sid, m in self._members.items():
                        if results[sid] is not None:
                            flags.extend(self.monitor.observe(
                                sid, results[sid].vet,
                                first=m.stream.first_retained,
                                tenant=m.tenant))
            tick_span.set(dispatches=dispatches, rows=rows)

        self._dispatches += dispatches
        self._rows += rows
        self._padded_rows += padded
        self._deferred += sum(deferred.values())
        return MuxTick(results=results, serviced=serviced, deferred=deferred,
                       urgent=plan.urgent, dispatches=dispatches, rows=rows,
                       padded_rows=padded, flags=tuple(flags))

    def flush(self, max_ticks: int = 1_000_000) -> MuxTick:
        """Tick until no stream has deferred work (drain the backlog after a
        burst, or before reading final fleet state); returns the last tick.

        Raises:
            RuntimeError: no convergence within ``max_ticks`` (new work
                arriving concurrently).

        Example::

            >>> mux = VetMux(VetEngine("numpy", buckets=64), budget=2)
            >>> _ = mux.register("w0", window=8, stride=4, capacity=64)
            >>> _ = mux.feed("w0", np.linspace(1e-3, 2e-3, 40))
            >>> mux.tick().deferred        # budget 2 of 9 pending rows
            {'w0': 7}
            >>> mux.flush().deferred       # backlog drained, nothing lost
            {}
        """
        return _flush_loop(self.tick, max_ticks)

    # ------------------------------------------------------ checkpointing
    def state_dict(self) -> dict:
        """Pickle-safe snapshot of the whole mux: every member stream's
        state plus planner staleness and the lifetime counters.

        The transport layer checkpoints shard workers with this so a killed
        process resumes mid-job without
        re-vetting committed windows.  Engine state is deliberately *not*
        captured: the result cache and the resolved device are per-process
        artifacts that rebuild on demand — ``load_state_dict`` binds the
        restored streams to the current mux's engine.
        """
        return {
            "members": [
                {"sid": sid, "priority": m.priority, "tenant": m.tenant,
                 "staleness": m.staleness, "stream": m.stream.state_dict()}
                for sid, m in self._members.items()
            ],
            "counters": {
                "ticks": self._ticks, "dispatches": self._dispatches,
                "rows": self._rows, "padded_rows": self._padded_rows,
                "deferred": self._deferred,
            },
            "monitor": (self.monitor.state_dict()
                        if self.monitor is not None else None),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore a ``state_dict`` snapshot, replacing every member.

        Registration order, staleness aging, pending windows, retained
        rows and the vetted watermark all survive, so the next ``tick()``
        continues exactly where the snapshot stopped — committed windows
        are never re-vetted (the crash-recovery invariant the transport
        suite locks with lifetime row/dispatch counters).
        """
        members: "OrderedDict[Hashable, _Member]" = OrderedDict()
        for rec in state["members"]:
            member = _Member(VetStream.from_state(self.engine, rec["stream"]),
                             rec["priority"], rec["tenant"])
            member.staleness = rec["staleness"]
            members[rec["sid"]] = member
        self._members = members
        c = state["counters"]
        self._ticks = c["ticks"]
        self._dispatches = c["dispatches"]
        self._rows = c["rows"]
        self._padded_rows = c["padded_rows"]
        self._deferred = c["deferred"]
        # Monitor state rides along so restored muxes neither re-flag old
        # shifts nor lose the anomaly count (``stats`` equality after a
        # round trip).  Snapshots predating the monitor restore to a fresh
        # one.
        mon = state.get("monitor")
        if mon is not None and self.monitor is not None:
            self.monitor.load_state_dict(mon)
