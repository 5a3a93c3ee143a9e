"""ShardedVetMux: partition a fleet mux across shards, merge job-level vets.

The port of ``repro.fleet.shard`` (the same placement, budget split and
merge arithmetic; engines default to the ``cuda`` backend where the
reference's default to ``jax``).  The process transport that the reference
also places through ``ShardPlacer`` is not ported yet (ROADMAP A.8).

A single ``VetMux`` coalesces thousands of live streams into per-tick batched
dispatches — but it is one object on one engine, i.e. one process.  The
paper's measure only means something at *job* scale: ``vet_job`` is the mean
over every task in the job (§4.4), so once the fleet no longer fits one
process the estimator has to become a set of per-process estimators whose
partial reductions merge into the same job-level numbers.  This module is
that layer:

- ``ShardedVetMux`` partitions registered streams across ``K`` shard muxes.
  Each shard owns its *own* ``VetEngine`` — shards model separate
  processes/hosts, so nothing (compiled functions, result caches, dispatch
  counters) is shared between them.  The public surface is the single-mux
  surface: ``register`` / ``deregister`` / ``feed`` / ``tick`` / ``flush`` /
  ``stats``, so every ``VetMux`` consumer can opt in by swapping the
  constructor.
- **Placement** is deterministic (no RNG): ``"pack"`` (default) greedy
  bin-packs by each stream's expected per-tick delta size with window-length
  affinity — same-length streams co-locate so a shard tick stays one
  dispatch per *locally present* length, and a length only spills to a new
  shard when load imbalance exceeds one stream's expected delta.
  ``"round_robin"`` is the trivial alternative.  Either way the same
  registration/deregistration history always yields the same assignment
  (same seed => same placement — the churn suites depend on it).
- **A tick fans out, then merges.**  The job-level ``budget`` is first
  water-filled across shards by pending demand (``schedule.split_budget``),
  each shard plans and coalesces its own tick under its slice (fairness
  applies per shard, then per tenant within the shard), and the per-shard
  ``MuxTick``s merge into one ``ShardTick``: union of per-stream results
  (rows bitwise equal to a single mux over the same feeds on numpy, 1e-5 on
  torch/cuda — ``tests/test_torch_shard.py``), summed dispatch/row counters,
  and the job-level reduction below.
- **Job-level merge.**  Each shard reduces its tick to a ``JobVet`` partial
  (stream-count-weighted newest-window vet/EI/OC means); ``merge_job``
  combines partials exactly the way a cross-process reducer would — weighted
  by stream counts, so the merged ``vet_job`` equals the single-mux mean to
  float-sum reassociation (<= 1e-9 in the differential suite).

What sharding buys (``benchmarks/fleet_shard.py``): the *per-shard* maximum
dispatch count and row load per tick fall as shards are added — each model
process does strictly less estimation work — while the fleet-total dispatch
count stays within ``single-mux + K`` per tick (placement keeps shape
buckets intact instead of shattering them).
"""

from __future__ import annotations

from typing import (
    Dict,
    Hashable,
    Iterable,
    Iterator,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np

from ..engine import VetEngine, VetStream
from ..obs.trace import span as _span
from .anomaly import RegimeShift
from .mux import BatchVetResult, MuxStats, MuxTick, VetMux, _flush_loop
from .schedule import split_budget

__all__ = ["JobVet", "ShardPlacer", "ShardTick", "ShardedVetMux",
           "job_reduce", "merge_job"]

PLACEMENTS = ("pack", "round_robin")


class JobVet(NamedTuple):
    """One job-level (or per-shard partial) vet reduction.

    ``vet_job`` is the paper's §4.4 mean of per-task vets over the newest
    complete window of every stream that has one; ``ei``/``oc`` are the
    matching stream-count-weighted means of the newest-window EI/OC (the
    job's estimated ideal and overhead cost per task).  ``streams`` is the
    weight — the number of streams folded in — which is what makes partials
    mergeable across shards/processes (``merge_job``).
    """

    vet_job: float
    ei: float  # mean newest-window estimated ideal cost (seconds)
    oc: float  # mean newest-window estimated overhead cost (seconds)
    streams: int  # streams with a complete window (the merge weight)


def job_reduce(tick: MuxTick) -> Optional[JobVet]:
    """Reduce one mux tick to its ``JobVet`` partial.

    Returns ``None`` when no stream in the tick has a complete window yet
    (an empty partial carries no weight).  This is the per-process half of
    the job-level reduction: a shard (or a remote host) computes it locally
    and ships four numbers instead of its per-stream rows.

    Example::

        >>> from repro_torch.engine import VetEngine
        >>> from repro_torch.fleet import VetMux
        >>> mux = VetMux(VetEngine("numpy", buckets=64))
        >>> _ = mux.register("w0", window=8, stride=4)
        >>> _ = mux.feed("w0", np.linspace(1e-3, 2e-3, 16))
        >>> part = job_reduce(mux.tick())
        >>> part.streams
        1
        >>> part.vet_job >= 1.0
        True
    """
    newest_vet: List[float] = []
    newest_ei: List[float] = []
    newest_oc: List[float] = []
    for res in tick.results.values():
        if res is not None and res.workers > 0:
            newest_vet.append(float(res.vet[-1]))
            newest_ei.append(float(res.ei[-1]))
            newest_oc.append(float(res.oc[-1]))
    if not newest_vet:
        return None
    n = len(newest_vet)
    return JobVet(vet_job=float(np.mean(newest_vet)),
                  ei=float(np.mean(newest_ei)),
                  oc=float(np.mean(newest_oc)), streams=n)


def merge_job(parts: Iterable[Optional[JobVet]]) -> JobVet:
    """Merge per-shard ``JobVet`` partials into the job-level reduction.

    Stream-count-weighted: ``merge([p1, p2]).vet_job`` equals the mean over
    the union of both shards' streams, exactly as one mux over the whole
    fleet would compute it (up to float-sum reassociation).  ``None``
    partials (shards with no complete window yet) carry no weight.

    Raises:
        ValueError: when every partial is ``None``/absent — there is no
            window anywhere to reduce over (same contract as
            ``MuxTick.vet_job``).

    Example::

        >>> a = JobVet(vet_job=2.0, ei=1.0, oc=1.0, streams=2)
        >>> b = JobVet(vet_job=5.0, ei=1.0, oc=4.0, streams=1)
        >>> merge_job([a, None, b])
        JobVet(vet_job=3.0, ei=1.0, oc=2.0, streams=3)
    """
    live = [p for p in parts if p is not None and p.streams > 0]
    if not live:
        raise ValueError("no stream has a complete window yet")
    n = sum(p.streams for p in live)
    return JobVet(
        vet_job=sum(p.vet_job * p.streams for p in live) / n,
        ei=sum(p.ei * p.streams for p in live) / n,
        oc=sum(p.oc * p.streams for p in live) / n,
        streams=n,
    )


class ShardTick(NamedTuple):
    """One sharded tick's merged outcome.

    Field-compatible with ``MuxTick`` (``results`` / ``serviced`` /
    ``deferred`` / ``urgent`` / ``dispatches`` / ``rows`` / ``padded_rows``
    mean the same things, merged over all shards), plus the per-shard
    breakdown: ``shards[k]`` is shard ``k``'s own ``MuxTick`` and
    ``budgets[k]`` the row budget it was water-filled for this tick
    (``None`` = unbounded).  ``accounts`` is per-shard transport accounting
    (round trips / retries / respawns / checkpoints / wall-clock) — empty
    for the in-process fleet, populated by
    ``fleet.transport.TransportVetMux``.
    """

    results: Dict[Hashable, Optional[BatchVetResult]]
    serviced: Dict[Hashable, int]  # stream -> window rows dispatched
    deferred: Dict[Hashable, int]  # stream -> rows pushed to later ticks
    urgent: Tuple[Hashable, ...]  # streams served out-of-budget, shard order
    dispatches: int  # engine dispatches across all shards this tick
    rows: int  # window rows committed across all shards
    padded_rows: int  # pow2 padding overhead rows across all shards
    shards: Tuple[MuxTick, ...]  # per-shard ticks, in shard order
    budgets: Tuple[Optional[int], ...]  # per-shard water-filled budgets
    accounts: tuple = ()  # per-shard ShardAccount, transport driver only
    flags: Tuple[RegimeShift, ...] = ()  # regime shifts raised, shard order

    @property
    def job(self) -> JobVet:
        """The merged job-level reduction over every shard's partial."""
        return merge_job(job_reduce(t) for t in self.shards)

    @property
    def vet_job(self) -> float:
        """Job-level vet (paper §4.4) merged across shards; equals the
        single-mux ``MuxTick.vet_job`` over the same feeds to <= 1e-9."""
        return self.job.vet_job


class _Placement(NamedTuple):
    """One stream's placement record (for deterministic rebalancing)."""

    shard: int
    weight: int  # expected per-tick delta rows (bin-packing load unit)
    length: int  # window length (dispatch shape-bucket key)


class ShardPlacer:
    """Deterministic stream -> shard placement, shared by every fleet
    driver.

    Owns the registration census (placement records, per-shard load, and
    per-shard window-length counts) that the ``"pack"`` policy packs
    against.  ``ShardedVetMux`` (in-process shards) and
    the reference's ``repro.fleet.transport.TransportVetMux`` (real worker
    processes; not ported yet) both
    place through this class, so moving a fleet across the process boundary
    reproduces the identical assignment — which is what lets the transport
    differential suite compare the two drivers shard by shard.
    """

    def __init__(self, n_shards: int, policy: str = "pack"):
        if policy not in PLACEMENTS:
            raise ValueError(
                f"placement must be one of {PLACEMENTS}, got {policy!r}")
        self.n_shards = int(n_shards)
        self.policy = policy
        # sid -> (shard, weight, length), in registration order (the order
        # ids()/tick results iterate in, mirroring a single mux).
        self.placed: Dict[Hashable, _Placement] = {}
        self.loads = [0] * self.n_shards  # sum of member weights per shard
        # per shard: window length -> member count (dispatch bucket census)
        self.lengths: List[Dict[int, int]] = [{} for _ in range(self.n_shards)]
        self._rr = 0  # round_robin cursor (never rewound: deterministic)

    @staticmethod
    def delta_weight(window: int, stride: int, capacity: int) -> int:
        """Expected per-tick delta rows, bounded by what the ring can hold
        pending at once — the bin-packing load unit.  Identical geometry
        => identical weight, so placement is a pure function of the
        registration history."""
        return max(1, (capacity - window) // stride + 1)

    def choose(self, weight: int, length: int) -> int:
        """Deterministic shard choice for a new stream; see the module
        docstring for the two policies.  Pure: call ``add`` to record it."""
        if self.policy == "round_robin":
            k = self._rr % self.n_shards
            self._rr += 1
            return k
        # "pack": greedy bin-pack by load, with window-length affinity — a
        # shard already hosting this length is preferred unless it is more
        # than one expected-delta heavier than the best alternative (then
        # the length spills: balance beats bucket purity, but only just).
        best, best_key = 0, None
        for k in range(self.n_shards):
            hosts = length in self.lengths[k]
            cost = self.loads[k] + (0 if hosts else weight)
            key = (cost, 0 if hosts else 1, k)
            if best_key is None or key < best_key:
                best, best_key = k, key
        return best

    def add(self, stream_id: Hashable, shard: int, weight: int,
            length: int) -> None:
        self.placed[stream_id] = _Placement(shard, weight, length)
        self.loads[shard] += weight
        self.lengths[shard][length] = self.lengths[shard].get(length, 0) + 1

    def remove(self, stream_id: Hashable) -> _Placement:
        placed = self.placed.pop(self.require(stream_id))
        self.loads[placed.shard] -= placed.weight
        census = self.lengths[placed.shard]
        census[placed.length] -= 1
        if census[placed.length] <= 0:
            del census[placed.length]
        return placed

    def require(self, stream_id: Hashable) -> Hashable:
        if stream_id not in self.placed:
            raise KeyError(f"stream {stream_id!r} is not registered "
                           f"({len(self.placed)} streams live)")
        return stream_id

    def shard_of(self, stream_id: Hashable) -> int:
        return self.placed[self.require(stream_id)].shard


class ShardedVetMux:
    """K-shard fleet mux with a merged job-level vet.

    Drop-in for ``VetMux`` at the call sites that opt in (the constructor
    differs; ``register``/``feed``/``tick``/``flush``/``stats`` do not)::

        fleet = ShardedVetMux(4, backend="cuda", budget=1024)
        for wid in workers:
            fleet.register(wid, window=200, stride=100)
        while serving:
            for wid, chunk in arrivals:
                fleet.feed(wid, chunk)
            tick = fleet.tick()           # fans out K shard ticks, merges
            dashboard.update(tick.vet_job, tick.results)

    Args:
        shards: number of shard muxes (>= 1).  Ignored when ``engines`` is
            given (one shard per engine).
        engines: explicit per-shard engines (each shard models one
            process/host, so engines are never shared between shards).
        engine: a template engine; shard 0 uses it directly and shards
            1..K-1 get fresh engines with the same configuration.  Mutually
            exclusive with ``engines``.
        backend: backend for the default per-shard engines (``buckets=64``,
            the fleet control-loop convention) when neither ``engines`` nor
            ``engine`` is given.
        budget: job-level window-row cap per tick, water-filled across
            shards by pending demand (``None`` = unbounded).
        tenant_weights / urgent_headroom: forwarded to every shard's
            planner (fairness applies within each shard's slice).
        placement: ``"pack"`` (default — deterministic greedy bin-packing
            by expected delta size with window-length affinity) or
            ``"round_robin"``.

    Raises:
        ValueError: on ``shards < 1``, an unknown ``placement``, both
            ``engines`` and ``engine`` given, or a ``shards``/``engines``
            length mismatch.

    Example::

        >>> fleet = ShardedVetMux(2, backend="numpy")
        >>> for i in range(4):
        ...     _ = fleet.register(i, window=8, stride=4)
        >>> sorted(fleet.assignment.values())   # balanced across 2 shards
        [0, 0, 1, 1]
        >>> for i in range(4):
        ...     _ = fleet.feed(i, np.linspace(1e-3, 2e-3, 16) * (i + 1))
        >>> tick = fleet.tick()
        >>> tick.rows, len(tick.shards)
        (12, 2)
        >>> tick.vet_job >= 1.0                 # merged job-level measure
        True
    """

    def __init__(self, shards: Optional[int] = None, *,
                 engines: Optional[Sequence[VetEngine]] = None,
                 engine: Optional[VetEngine] = None,
                 backend: str = "cuda",
                 budget: Optional[int] = None,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 urgent_headroom: int = 0,
                 placement: str = "pack",
                 tracer=None):
        if engines is not None and engine is not None:
            raise ValueError("pass engines= (one per shard) or engine= "
                             "(a template), not both")
        if engines is not None:
            engines = list(engines)
            if not engines:
                raise ValueError("engines must name at least one shard")
            if shards is not None and shards != len(engines):
                raise ValueError(
                    f"shards={shards} but {len(engines)} engines given")
        else:
            shards = 1 if shards is None else int(shards)
            if shards < 1:
                raise ValueError(f"shards must be >= 1, got {shards}")
            if engine is not None:
                engines = [engine] + [engine.clone()
                                      for _ in range(shards - 1)]
            else:
                engines = [VetEngine(backend, buckets=64)
                           for _ in range(shards)]
        if budget is not None:
            budget = int(budget)
            if budget < 1:
                raise ValueError(
                    f"budget must be >= 1 window row, got {budget}")
        self.budget = budget
        self._placer = ShardPlacer(len(engines), placement)
        self._muxes = [VetMux(e, tenant_weights=tenant_weights,
                              urgent_headroom=urgent_headroom)
                       for e in engines]
        self._ticks = 0
        self.tracer = None
        if tracer is not None:
            self.set_tracer(tracer)

    def set_tracer(self, tracer) -> None:
        """Attach (or detach, with ``None``) a ``repro_torch.obs.Tracer``.  Each
        shard mux gets its own ``tid`` lane (the shard index), so one trace
        shows the K in-process shards side by side; the fan-out/merge spans
        land on lane 0."""
        self.tracer = tracer
        for k, m in enumerate(self._muxes):
            m.set_tracer(tracer, tid=k)

    @property
    def placement(self) -> str:
        return self._placer.policy

    @property
    def _placed(self) -> Dict[Hashable, _Placement]:
        # Registration-order placement records (the placer owns them).
        return self._placer.placed

    def __repr__(self) -> str:
        return (f"ShardedVetMux(shards={self.n_shards}, "
                f"streams={len(self._placed)}, budget={self.budget}, "
                f"placement={self.placement!r}, ticks={self._ticks})")

    # ----------------------------------------------------------- topology
    @property
    def n_shards(self) -> int:
        return len(self._muxes)

    def shard(self, k: int) -> VetMux:
        """The k-th shard mux (its engine, stats, and streams are local to
        the shard — the per-process view)."""
        return self._muxes[k]

    @property
    def engines(self) -> Tuple[VetEngine, ...]:
        return tuple(m.engine for m in self._muxes)

    @property
    def assignment(self) -> Dict[Hashable, int]:
        """stream_id -> shard index, in registration order (a copy)."""
        return {sid: p.shard for sid, p in self._placed.items()}

    def shard_of(self, stream_id: Hashable) -> int:
        return self._placer.shard_of(stream_id)

    def _require(self, stream_id: Hashable) -> Hashable:
        return self._placer.require(stream_id)

    # ------------------------------------------------------- registration
    def register(self, stream_id: Hashable, *, window: Optional[int] = None,
                 stride: int = 1, capacity: Optional[int] = None,
                 history: Optional[int] = None, priority: float = 0.0,
                 tenant: str = "default",
                 stream: Optional[VetStream] = None) -> VetStream:
        """Add a stream to the fleet on a deterministically chosen shard.

        Same contract as ``VetMux.register``: pass the window geometry and
        the chosen shard's mux creates the stream on *its* engine, or pass
        an existing ``stream`` — which pins placement to the shard owning
        its engine (coalesced dispatches run on one engine per shard).

        Returns:
            The (created or attached) ``VetStream``.

        Raises:
            ValueError: duplicate ``stream_id``; neither ``window`` nor
                ``stream`` given; an attached stream bound to none of the
                shard engines.
        """
        if stream_id in self._placed:
            raise ValueError(f"stream {stream_id!r} is already registered")
        if stream is not None:
            for k, m in enumerate(self._muxes):
                if stream.engine is m.engine:
                    shard = k
                    break
            else:
                raise ValueError(
                    "attached stream must be bound to one of the shard "
                    "engines (coalesced dispatches run on one engine per "
                    "shard); build it with VetStream(fleet.shard(k).engine, "
                    "...) or let register() create it")
            weight = ShardPlacer.delta_weight(stream.window, stream.stride,
                                              stream.capacity)
            length = stream.window
        else:
            if window is None:
                raise ValueError(
                    "register needs window= (to create the stream) or "
                    "stream= (to attach an existing one)")
            window = int(window)
            cap = int(capacity) if capacity is not None else 4 * window
            weight = ShardPlacer.delta_weight(window, int(stride), cap)
            length = window
            shard = self._placer.choose(weight, length)
        out = self._muxes[shard].register(
            stream_id, window=window, stride=stride, capacity=capacity,
            history=history, priority=priority, tenant=tenant, stream=stream)
        self._placer.add(stream_id, shard, weight, length)
        return out

    def deregister(self, stream_id: Hashable) -> VetStream:
        """Remove a stream (fleet churn); returns it for standalone use.

        The shard's load/length census shrinks deterministically, so the
        next ``register`` re-balances toward the vacated shard — the same
        churn history always reproduces the same assignment.
        """
        placed = self._placer.remove(stream_id)
        return self._muxes[placed.shard].deregister(stream_id)

    def stream(self, stream_id: Hashable) -> VetStream:
        return self._muxes[self._placed[self._require(stream_id)].shard] \
            .stream(stream_id)

    def ids(self) -> Iterator[Hashable]:
        """Stream ids in registration order (across all shards)."""
        return iter(self._placed)

    def __contains__(self, stream_id: Hashable) -> bool:
        return stream_id in self._placed

    def __len__(self) -> int:
        return len(self._placed)

    @property
    def stats(self) -> MuxStats:
        """Merged lifetime counters (``ticks`` counts *fan-out* ticks; the
        dispatch/row/deferral sums are fleet totals over all shards)."""
        per = [m.stats for m in self._muxes]
        return MuxStats(ticks=self._ticks,
                        dispatches=sum(s.dispatches for s in per),
                        rows=sum(s.rows for s in per),
                        padded_rows=sum(s.padded_rows for s in per),
                        deferred=sum(s.deferred for s in per),
                        streams=len(self._placed),
                        anomalies=sum(s.anomalies for s in per))

    @property
    def shard_stats(self) -> Tuple[MuxStats, ...]:
        """Per-shard ``MuxStats``, in shard order (the per-process view)."""
        return tuple(m.stats for m in self._muxes)

    # ------------------------------------------------------------- ingest
    def feed(self, stream_id: Hashable, times) -> int:
        """Append a chunk to one stream via its shard's mux.

        Under ring pressure the *owning shard* ticks coalesced (the
        per-process overrun protection — a shard never reaches across
        process boundaries mid-feed); a job-level ``budget`` never applies
        to pressure ticks, which are correctness-driven.
        """
        return self._muxes[self._placed[self._require(stream_id)].shard] \
            .feed(stream_id, times)

    # --------------------------------------------------------------- tick
    def tick(self) -> ShardTick:
        """Fan a tick out to every shard, then merge (see module docstring).

        With a job-level ``budget``, per-shard slices are water-filled by
        pending demand first (``schedule.split_budget``); each shard's own
        planner then applies priority/staleness/tenant fairness within its
        slice.  Ring-overrun-urgent streams are always served in full by
        their shard regardless of the slice.
        """
        self._ticks += 1
        with _span(self.tracer, "fleet.tick", shards=self.n_shards,
                   streams=len(self._placed)):
            with _span(self.tracer, "fleet.plan"):
                if self.budget is None:
                    budgets: Tuple[Optional[int], ...] = \
                        (None,) * self.n_shards
                else:
                    demands = [0] * self.n_shards
                    for sid, placed in self._placed.items():
                        demands[placed.shard] += self._muxes[placed.shard] \
                            .stream(sid).pending_windows
                    budgets = tuple(split_budget(self.budget, demands))
            ticks: List[MuxTick] = []
            for m, b in zip(self._muxes, budgets):
                m.budget = b
                try:
                    ticks.append(m.tick())
                finally:
                    # pressure ticks between fan-outs: unbounded
                    m.budget = None
            with _span(self.tracer, "fleet.merge"):
                results: Dict[Hashable, Optional[BatchVetResult]] = {}
                serviced: Dict[Hashable, int] = {}
                deferred: Dict[Hashable, int] = {}
                for sid, placed in self._placed.items():  # registration order
                    t = ticks[placed.shard]
                    results[sid] = t.results[sid]
                    if sid in t.serviced:
                        serviced[sid] = t.serviced[sid]
                    if sid in t.deferred:
                        deferred[sid] = t.deferred[sid]
        return ShardTick(
            results=results, serviced=serviced, deferred=deferred,
            urgent=tuple(sid for t in ticks for sid in t.urgent),
            dispatches=sum(t.dispatches for t in ticks),
            rows=sum(t.rows for t in ticks),
            padded_rows=sum(t.padded_rows for t in ticks),
            shards=tuple(ticks), budgets=budgets,
            flags=tuple(f for t in ticks for f in t.flags))

    def flush(self, max_ticks: int = 1_000_000) -> ShardTick:
        """Tick until no shard has deferred work; returns the last tick.

        Performs at most ``max_ticks`` ticks, the first one included —
        the same boundary as ``VetMux.flush`` (shared loop).

        Raises:
            ValueError: ``max_ticks < 1``.
            RuntimeError: when the backlog does not converge within
                ``max_ticks`` ticks (new work arriving concurrently).
        """
        return _flush_loop(self.tick, max_ticks)

    def close(self) -> None:
        """Release fleet resources — a no-op here, where every shard lives
        in this process.  Surface symmetry with
        ``fleet.transport.TransportVetMux.close()`` (which terminates its
        worker processes), so consumers can hold either mux and always
        close it."""
