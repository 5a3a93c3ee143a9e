"""Scenario bank: seed-stable fleet workloads driving the simulator.

The port of ``repro.fleet.scenarios``: host-side workload generators on
the port's ``profiling.simulate_records``, seeded with
``numpy.random.default_rng`` exactly as the reference seeds them, so every
array and event equals the reference's (``tests/test_torch_scenarios.py``).

Each scenario compiles a fleet shape (stream specs: window geometry,
priority, tenant) plus a per-tick event script (record-time chunks from the
seed-stable ``repro_torch.profiling.simulator``, joins, leaves) into a
``FleetScenario`` that ``play()`` can drive through any ``VetMux`` — the
differential suites replay the same scenario through the mux and through
independent per-stream ``tick()``s and require equal rows, and the fleet
benchmark scales the same shapes to 256-1024 workers.

The bank (``SCENARIOS``):

- ``uniform``            — homogeneous fleet, steady identical arrivals; the
  best case for coalescing (one shape bucket, one dispatch per tick).
- ``skewed_stragglers``  — a fraction of workers carries a much heavier
  Pareto overhead channel (the paper's straggler signature: vet outliers).
- ``bursty``             — per-tick arrivals drawn from {nothing, trickle,
  burst}; quiet workers must cost nothing, bursts must not overrun rings.
- ``mixed_windows``      — window lengths cycle through a small set, so a
  mux tick needs one dispatch per distinct length (shape buckets), not one
  per stream.
- ``churn``              — workers join mid-run and leave before the end;
  registration order, results and dispatch counts must stay deterministic.

The anomaly bank models the failure classes of "Characterization of
Performance Anomalies in Hadoop" (arXiv:1505.01919) by shaping the
simulator's *reducible-overhead channel* with a per-record multiplier
envelope — ideal times stay untouched, so the injected shift is exactly the
kind of regime change the vet measure is built to see.  Each carries its
injected ``onset_tick`` and ``affected`` stream set as ground truth for the
anomaly monitor's differential suites (windows are non-overlapping —
``window == stride == chunk`` — so window index == tick index):

- ``contention_onset``   — the whole fleet's overhead channel steps up at
  the onset (a co-tenant job lands on every node).
- ``degraded_node``      — only a slice of the fleet degrades; the rest must
  stay unflagged.
- ``fail_restart``       — overhead spikes hard at the onset and recovers
  after a fixed outage (failure + restart); the monitor should localize the
  failure edge first.
- ``diurnal``            — a smooth raised-cosine swell centered on the
  onset (daily load swing), testing localization without a sharp edge.
- ``hetero_tiers``       — statically slow/fast hardware tiers (constant
  overhead level: a *negative control* that must never flag) plus a
  migrated group whose level shifts at the onset.

The *tunable* scenario (``tunable()`` / ``TunableScenario``) is the
differential lock for the online autotuner (``repro_torch.sched.tuner``): a
mutable workload whose reducible-overhead channel is shaped by the current
knob assignment through a known envelope with a known optimum, so a tuner
driving it through ``knob_hooks`` can be checked against exhaustive grid
search.  It is deliberately *not* in ``SCENARIOS`` — it has no fixed event
script (each tick's records depend on the knobs at that tick), so ``play``
and the replay-differential suites cannot drive it.

All randomness flows from ``numpy.random.default_rng(seed)`` / the
simulator's seeded draws, so every scenario is bitwise reproducible.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np

from ..profiling import simulate_records
from .knobs import Knob, KnobHooks

__all__ = ["ANOMALY_SCENARIOS", "FleetEvent", "FleetScenario", "SCENARIOS",
           "StreamSpec", "TunableScenario", "build", "play", "tunable"]


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """One stream's registration parameters."""

    stream_id: str
    window: int
    stride: int
    capacity: int
    priority: float = 0.0
    tenant: str = "default"

    def register(self, mux) -> None:
        mux.register(self.stream_id, window=self.window, stride=self.stride,
                     capacity=self.capacity, priority=self.priority,
                     tenant=self.tenant)


@dataclasses.dataclass(frozen=True)
class FleetEvent:
    """One tick of fleet traffic: chunks to feed, plus churn."""

    chunks: Mapping[str, np.ndarray]  # stream_id -> record-time chunk
    joins: Tuple[StreamSpec, ...] = ()  # registered before this tick's feeds
    leaves: Tuple[str, ...] = ()  # deregistered after this tick


@dataclasses.dataclass(frozen=True)
class FleetScenario:
    """A named fleet shape + its per-tick event script.

    Anomaly-bank scenarios also carry their injected ground truth:
    ``onset_tick`` is the first tick whose records are drawn from the
    anomalous regime (``None`` for scenarios with no injected shift), and
    ``affected`` names the streams the shift touches — the differential
    suites require the anomaly monitor to localize the onset on exactly
    those streams and stay quiet on the rest.
    """

    name: str
    specs: Tuple[StreamSpec, ...]
    events: Tuple[FleetEvent, ...]
    onset_tick: int | None = None
    affected: Tuple[str, ...] = ()

    @property
    def n_streams(self) -> int:
        return len(self.specs) + sum(len(e.joins) for e in self.events)


def play(scenario: FleetScenario, mux) -> List:
    """Drive a scenario through a mux: register, feed, tick per event.

    Returns the per-event ``MuxTick`` list.  Joins are applied before the
    event's feeds, leaves after its tick — a leaver's final rows are in the
    tick that saw its last records.
    """
    for spec in scenario.specs:
        spec.register(mux)
    out = []
    for event in scenario.events:
        for spec in event.joins:
            spec.register(mux)
        for sid, chunk in event.chunks.items():
            mux.feed(sid, chunk)
        out.append(mux.tick())
        for sid in event.leaves:
            mux.deregister(sid)
    return out


# ------------------------------------------------------------------ bank
def _worker_times(n: int, seed: int, worker: int,
                  overhead_scale: float = 5e-3) -> np.ndarray:
    """One worker's whole-run record times (seed-stable simulator draw)."""
    return simulate_records(n, seed=seed * 1000 + worker,
                            overhead_scale=overhead_scale).times


def _sid(i: int) -> str:
    return f"w{i:04d}"


def uniform(*, n_workers: int = 8, n_ticks: int = 6, window: int = 32,
            stride: int = 0, chunk: int = 0, seed: int = 0) -> FleetScenario:
    """Homogeneous fleet, steady arrivals: one shape bucket per tick."""
    stride = stride or window // 2
    chunk = chunk or window // 2
    specs = tuple(StreamSpec(_sid(i), window, stride, 4 * window)
                  for i in range(n_workers))
    times = {s.stream_id: _worker_times(n_ticks * chunk, seed, i)
             for i, s in enumerate(specs)}
    events = tuple(
        FleetEvent(chunks={sid: t[k * chunk:(k + 1) * chunk]
                           for sid, t in times.items()})
        for k in range(n_ticks))
    return FleetScenario("uniform", specs, events)


def skewed_stragglers(*, n_workers: int = 8, n_ticks: int = 6,
                      window: int = 32, straggler_frac: float = 0.25,
                      straggler_boost: float = 8.0,
                      seed: int = 0) -> FleetScenario:
    """A slice of the fleet pays a much heavier reducible-overhead tail."""
    stride = window // 2
    chunk = window // 2
    n_slow = max(1, int(n_workers * straggler_frac))
    specs = tuple(StreamSpec(_sid(i), window, stride, 4 * window)
                  for i in range(n_workers))
    times = {
        s.stream_id: _worker_times(
            n_ticks * chunk, seed, i,
            overhead_scale=5e-3 * (straggler_boost if i < n_slow else 1.0))
        for i, s in enumerate(specs)
    }
    events = tuple(
        FleetEvent(chunks={sid: t[k * chunk:(k + 1) * chunk]
                           for sid, t in times.items()})
        for k in range(n_ticks))
    return FleetScenario("skewed_stragglers", specs, events)


def bursty(*, n_workers: int = 8, n_ticks: int = 8, window: int = 32,
           seed: int = 0) -> FleetScenario:
    """Arrivals per tick drawn from {0, trickle, burst} per worker."""
    stride = window // 2
    rng = np.random.default_rng(seed)
    # Ring sized for the worst burst: feed()/mux.feed() would coalesce-tick
    # under pressure anyway, but keeping bursts resident exercises pure
    # coalescing rather than overrun protection.
    burst = 3 * window
    specs = tuple(StreamSpec(_sid(i), window, stride, window + 2 * burst)
                  for i in range(n_workers))
    sizes = rng.choice([0, window // 4, burst], size=(n_ticks, n_workers),
                       p=[0.35, 0.45, 0.2])
    times = {s.stream_id: _worker_times(int(sizes[:, i].sum()) or 1, seed, i)
             for i, s in enumerate(specs)}
    cursor = {sid: 0 for sid in times}
    events = []
    for k in range(n_ticks):
        chunks: Dict[str, np.ndarray] = {}
        for i, s in enumerate(specs):
            size = int(sizes[k, i])
            if size:
                lo = cursor[s.stream_id]
                chunks[s.stream_id] = times[s.stream_id][lo:lo + size]
                cursor[s.stream_id] = lo + size
        events.append(FleetEvent(chunks=chunks))
    return FleetScenario("bursty", specs, tuple(events))


def mixed_windows(*, n_workers: int = 9, n_ticks: int = 6,
                  windows: Tuple[int, ...] = (16, 32, 64),
                  seed: int = 0,
                  strides_per_tick: int = 1) -> FleetScenario:
    """Heterogeneous window lengths: one dispatch per distinct length on the
    bucketed path, ONE total on the fused path.  ``strides_per_tick`` scales
    how many windows each stream completes per tick (capacity grows to
    hold them), for benchmark sweeps over per-tick batch depth."""
    specs = []
    for i in range(n_workers):
        w = windows[i % len(windows)]
        specs.append(StreamSpec(_sid(i), w, w // 2,
                                max(4, 2 + strides_per_tick) * w,
                                tenant=f"t{i % len(windows)}"))
    chunk = {s.stream_id: (s.window // 2) * strides_per_tick for s in specs}
    times = {s.stream_id: _worker_times(n_ticks * chunk[s.stream_id], seed, i)
             for i, s in enumerate(specs)}
    events = tuple(
        FleetEvent(chunks={
            sid: times[sid][k * c:(k + 1) * c]
            for sid, c in chunk.items()})
        for k in range(n_ticks))
    return FleetScenario("mixed_windows", tuple(specs), events)


def churn(*, n_workers: int = 8, n_ticks: int = 8, window: int = 32,
          seed: int = 0) -> FleetScenario:
    """Workers join mid-run and leave before the end (elastic fleet)."""
    stride = window // 2
    chunk = window // 2
    n_base = max(2, n_workers - n_workers // 3)
    n_join = n_workers - n_base
    join_tick = n_ticks // 3
    leave_tick = 2 * n_ticks // 3
    specs = tuple(StreamSpec(_sid(i), window, stride, 4 * window)
                  for i in range(n_base))
    joiners = tuple(StreamSpec(_sid(n_base + j), window, stride, 4 * window)
                    for j in range(n_join))
    leavers = tuple(s.stream_id for s in specs[:max(1, n_base // 4)])
    times = {_sid(i): _worker_times(n_ticks * chunk, seed, i)
             for i in range(n_base + n_join)}
    events = []
    for k in range(n_ticks):
        chunks = {
            s.stream_id: times[s.stream_id][k * chunk:(k + 1) * chunk]
            for s in specs
            if not (k > leave_tick and s.stream_id in leavers)}
        if k >= join_tick:
            # A joiner's life starts at join_tick: index its simulated run
            # by ticks-since-join so its first fed chunk is its first
            # simulated records.  (Indexing by the global tick silently
            # dropped each joiner's first join_tick*chunk records.)
            j = k - join_tick
            for s in joiners:
                chunks[s.stream_id] = \
                    times[s.stream_id][j * chunk:(j + 1) * chunk]
        events.append(FleetEvent(
            chunks=chunks,
            joins=joiners if k == join_tick else (),
            leaves=leavers if k == leave_tick else (),
        ))
    return FleetScenario("churn", specs, tuple(events))


# ------------------------------------------------------- anomaly bank
def _enveloped_times(n: int, seed: int, worker: int,
                     envelope: np.ndarray) -> np.ndarray:
    """One worker's run with the reducible-overhead channel shaped by a
    per-record multiplier envelope: ``ideal + overhead * m``.  ``m == 1``
    reproduces the simulator draw bitwise (at this scale); only the overhead
    channel moves, so the injected anomaly is pure reducible overhead
    (constant true EI).

    The anomaly bank draws its *baseline* overhead calmer than the default
    simulator (alpha=2.0 instead of 1.3, so the tail has finite variance,
    at scale 2e-3): per-window vets under the default alpha=1.3 tail swing
    1.2x-14x with no anomaly at all, which no onset detector should be
    asked to see through.  The injected multiplier envelopes then carry
    the entire anomaly signal."""
    prof = _anomaly_profile(n, seed, worker)
    return prof.ideal + prof.overhead * envelope


def _anomaly_profile(n: int, seed: int, worker: int):
    return simulate_records(n, seed=seed * 1000 + worker,
                            overhead_scale=2e-3, pareto_alpha=2.0)


def _per_tick_envelope(mt: np.ndarray, chunk: int) -> np.ndarray:
    """Expand a per-tick multiplier series to per-record (chunk records/tick)."""
    return np.repeat(np.asarray(mt, np.float64), chunk)


def _anomaly_fleet(n_workers: int, window: int,
                   tenant=None) -> Tuple[StreamSpec, ...]:
    """Non-overlapping-window fleet: window == stride, so one window
    completes per tick and window index == tick index."""
    return tuple(
        StreamSpec(_sid(i), window, window, 4 * window,
                   tenant=tenant(i) if tenant else "default")
        for i in range(n_workers))


def _chunk_events(times: Mapping[str, np.ndarray], n_ticks: int,
                  chunk: int) -> Tuple[FleetEvent, ...]:
    return tuple(
        FleetEvent(chunks={sid: t[k * chunk:(k + 1) * chunk]
                           for sid, t in times.items()})
        for k in range(n_ticks))


def contention_onset(*, n_workers: int = 8, n_ticks: int = 16,
                     window: int = 64, boost: float = 16.0,
                     seed: int = 0) -> FleetScenario:
    """Fleet-wide contention lands at the onset: every worker's overhead
    channel steps up by ``boost`` (1505.01919's co-located-job signature)."""
    onset = n_ticks // 2
    specs = _anomaly_fleet(n_workers, window)
    m = _per_tick_envelope(
        np.where(np.arange(n_ticks) >= onset, boost, 1.0), window)
    times = {s.stream_id: _enveloped_times(n_ticks * window, seed, i, m)
             for i, s in enumerate(specs)}
    return FleetScenario("contention_onset", specs,
                         _chunk_events(times, n_ticks, window),
                         onset_tick=onset,
                         affected=tuple(s.stream_id for s in specs))


def degraded_node(*, n_workers: int = 8, n_ticks: int = 16, window: int = 64,
                  degraded_frac: float = 0.25, boost: float = 16.0,
                  seed: int = 0) -> FleetScenario:
    """A slice of the fleet degrades at the onset (partial-node fault:
    failing disk, hot VM neighbour); the rest must stay unflagged."""
    onset = n_ticks // 2
    n_deg = max(1, int(n_workers * degraded_frac))
    specs = _anomaly_fleet(n_workers, window)
    step = _per_tick_envelope(
        np.where(np.arange(n_ticks) >= onset, boost, 1.0), window)
    flat = np.ones(n_ticks * window)
    times = {s.stream_id: _enveloped_times(
        n_ticks * window, seed, i, step if i < n_deg else flat)
        for i, s in enumerate(specs)}
    return FleetScenario("degraded_node", specs,
                         _chunk_events(times, n_ticks, window),
                         onset_tick=onset,
                         affected=tuple(s.stream_id
                                        for s in specs[:n_deg]))


def fail_restart(*, n_workers: int = 8, n_ticks: int = 16, window: int = 64,
                 outage_ticks: int = 5, boost: float = 20.0,
                 seed: int = 0) -> FleetScenario:
    """Hard failure at the onset, restart ``outage_ticks`` later: overhead
    spikes then recovers.  Ground truth is the *failure* edge — the monitor
    sees only normal+outage windows when it first fires, so its first flag
    should localize the onset, not the restart."""
    onset = max(2, n_ticks // 2 - 1)
    k = np.arange(n_ticks)
    m = _per_tick_envelope(
        np.where((k >= onset) & (k < onset + outage_ticks), boost, 1.0),
        window)
    specs = _anomaly_fleet(n_workers, window)
    times = {s.stream_id: _enveloped_times(n_ticks * window, seed, i, m)
             for i, s in enumerate(specs)}
    return FleetScenario("fail_restart", specs,
                         _chunk_events(times, n_ticks, window),
                         onset_tick=onset,
                         affected=tuple(s.stream_id for s in specs))


def diurnal(*, n_workers: int = 8, n_ticks: int = 16, window: int = 64,
            amplitude: float = 24.0, ramp_ticks: int = 2,
            seed: int = 0) -> FleetScenario:
    """Smooth daily-swing swell: a raised-cosine ramp of the overhead
    channel centered on the onset (no sharp edge to latch onto)."""
    onset = n_ticks // 2
    k = np.arange(n_ticks, dtype=np.float64)
    phase = np.clip((k - (onset - ramp_ticks / 2.0)) / ramp_ticks, 0.0, 1.0)
    m = _per_tick_envelope(1.0 + amplitude * 0.5 * (1.0 - np.cos(np.pi * phase)),
                           window)
    specs = _anomaly_fleet(n_workers, window)
    times = {s.stream_id: _enveloped_times(n_ticks * window, seed, i, m)
             for i, s in enumerate(specs)}
    return FleetScenario("diurnal", specs,
                         _chunk_events(times, n_ticks, window),
                         onset_tick=onset,
                         affected=tuple(s.stream_id for s in specs))


def hetero_tiers(*, n_workers: int = 9, n_ticks: int = 16, window: int = 64,
                 tiers: Tuple[float, ...] = (1.0, 4.0, 16.0),
                 boost: float = 16.0, seed: int = 0) -> FleetScenario:
    """Statically heterogeneous hardware tiers plus a migrated group.

    Two-thirds of the fleet runs on fixed hardware tiers that scale the
    *whole* runtime — ideal work and overhead alike — by a constant
    factor.  The vet measure is invariant to that scaling (slow hardware
    is not suboptimal: EI and OC grow together), so these streams are the
    negative control the monitor must never flag, no matter how slow
    their tier.  The last third gets migrated onto an oversubscribed node
    at the onset: only their reducible-overhead channel jumps (by
    ``boost``), and only those streams should flag."""
    onset = n_ticks // 2
    n_static = 2 * n_workers // 3
    specs = _anomaly_fleet(
        n_workers, window,
        tenant=lambda i: (f"tier{i % len(tiers)}" if i < n_static
                          else "migrated"))
    migrate = _per_tick_envelope(
        np.where(np.arange(n_ticks) >= onset, boost, 1.0), window)
    times = {}
    for i, s in enumerate(specs):
        if i < n_static:
            prof = _anomaly_profile(n_ticks * window, seed, i)
            times[s.stream_id] = (tiers[i % len(tiers)]
                                  * (prof.ideal + prof.overhead))
        else:
            times[s.stream_id] = _enveloped_times(n_ticks * window, seed, i,
                                                  migrate)
    return FleetScenario("hetero_tiers", specs,
                         _chunk_events(times, n_ticks, window),
                         onset_tick=onset,
                         affected=tuple(s.stream_id
                                        for s in specs[n_static:]))


ANOMALY_SCENARIOS: Dict[str, Callable[..., FleetScenario]] = {
    "contention_onset": contention_onset,
    "degraded_node": degraded_node,
    "fail_restart": fail_restart,
    "diurnal": diurnal,
    "hetero_tiers": hetero_tiers,
}

SCENARIOS: Dict[str, Callable[..., FleetScenario]] = {
    "uniform": uniform,
    "skewed_stragglers": skewed_stragglers,
    "bursty": bursty,
    "mixed_windows": mixed_windows,
    "churn": churn,
    **ANOMALY_SCENARIOS,
}


# ------------------------------------------------------- tunable scenario
class TunableScenario:
    """A knob-sensitive workload with a known optimum: the tuner's lock.

    Unlike the frozen bank scenarios, this one is *mutable*: each tick's
    record times depend on the knob assignment currently written into
    ``state`` (via the ``KnobHooks`` from :meth:`hooks`, the same seam a
    tuner uses against a live mux).  The knobs shape only the simulator's
    reducible-overhead channel through a multiplicative envelope

        ``envelope = prod_spsa (1 + curvature * |idx - idx*|) * factor[arm]``

    so the vet objective has a unique known minimum at :attr:`optimum`
    (every factor is 1 exactly there) and strictly unimodal coordinate
    slices everywhere else — exhaustive grid search provably lands on
    ``optimum``, which makes "did the online tuner find it?" a crisp
    differential test rather than a judgement call.

    Determinism contract: with ``noise == 0`` the per-worker base profile
    is drawn once and reused every tick, so a given assignment produces
    *bitwise identical* record bytes on every tick — the objective is a
    pure function of the assignment (and the engine's fingerprint cache
    turns repeat visits into hits).  With ``noise > 0`` a per-(tick,
    worker) seeded lognormal multiplier rides on the overhead channel:
    still reproducible, but the objective is noisy exactly the way
    arXiv:1611.10052 assumes.

    Windows are non-overlapping (``window == stride == chunk``): one
    window completes per stream per tick and contains only that tick's
    records, so tick ``t``'s vets reflect exactly the assignment applied
    before tick ``t``.
    """

    #: knob grids with the optimum interior on every axis; ``io_mode`` is
    #: deliberately unordered-in-effect (factors 1.55 / 1.0 / 1.3) so the
    #: index geometry is useless and only a bandit can tune it.
    DEFAULT_KNOBS = (Knob("n_micro", (1, 2, 4, 8)),
                     Knob("q_chunk", (16, 32, 64, 128)),
                     Knob("io_mode", (0, 1, 2), kind="bandit"))
    DEFAULT_OPTIMUM = {"n_micro": 4, "q_chunk": 32, "io_mode": 1}
    BANDIT_FACTORS = {"io_mode": (1.55, 1.0, 1.3)}

    def __init__(self, *, n_workers: int = 4, window: int = 48,
                 curvature: float = 0.4, noise: float = 0.0, seed: int = 0):
        self.name = "tunable"
        self.n_workers = int(n_workers)
        self.window = int(window)
        self.curvature = float(curvature)
        self.noise = float(noise)
        self.seed = int(seed)
        self.knobs = self.DEFAULT_KNOBS
        self.optimum = dict(self.DEFAULT_OPTIMUM)
        # Start at the far corner of every grid: worst n_micro/q_chunk,
        # worst bandit arm — the tuner has real distance to cover.
        self.state: Dict[str, object] = {k.name: k.values[0]
                                         for k in self.knobs}
        self._base = [_anomaly_profile(self.window, self.seed, i)
                      for i in range(self.n_workers)]

    @property
    def specs(self) -> Tuple[StreamSpec, ...]:
        return tuple(StreamSpec(_sid(i), self.window, self.window,
                                4 * self.window)
                     for i in range(self.n_workers))

    def hooks(self) -> KnobHooks:
        """The write-back seam: dict-backed hooks over :attr:`state`."""
        return KnobHooks.over_state(self.knobs, self.state)

    def envelope(self, assignment: Mapping | None = None) -> float:
        """Overhead multiplier for an assignment (current state if None)."""
        a = dict(self.state if assignment is None else assignment)
        m = 1.0
        for knob in self.knobs:
            idx = knob.index_of(a[knob.name])
            opt = knob.index_of(self.optimum[knob.name])
            if knob.kind == "spsa":
                m *= 1.0 + self.curvature * abs(idx - opt)
            else:
                m *= self.BANDIT_FACTORS[knob.name][idx]
        return m

    def chunks(self, tick: int) -> Dict[str, np.ndarray]:
        """One tick's record chunks under the *current* knob state."""
        m = self.envelope()
        out = {}
        for i, prof in enumerate(self._base):
            mult = m
            if self.noise:
                rng = np.random.default_rng([self.seed, 7919, tick, i])
                mult = m * float(np.exp(self.noise * rng.standard_normal()))
            out[_sid(i)] = prof.ideal + prof.overhead * mult
        return out

    def reset(self) -> None:
        """Back to the starting corner (for reuse across harness runs)."""
        for k in self.knobs:
            self.state[k.name] = k.values[0]


def tunable(**overrides) -> TunableScenario:
    """Build the tuner-lock scenario (factory mirroring the bank callables)."""
    return TunableScenario(**overrides)


def build(name: str, **overrides) -> FleetScenario:
    """Build a bank scenario by name (sizes overridable for tests/benchmarks)."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; choose from "
                         f"{sorted(SCENARIOS)}")
    return SCENARIOS[name](**overrides)
