"""Online vet-driven autotuning: the loop that *uses* the measure.

The port of ``repro.sched.tuner``: the same phase machine, seeded
``numpy.random.default_rng`` and grid oracle, so the port's tuner walks
the reference's trajectory under one objective
(``tests/test_torch_tuner.py``).

The paper measures how far a job sits from its lower bound; every layer so
far reports that number.  This module closes the loop: ``VetTuner`` treats
the fleet's per-tenant vet stream — read off ``MuxTick``/``ShardTick`` via
:func:`objective_from_tick` — as a noisy objective and walks the fleet's
knob grids online, writing each move back through the
``repro_torch.fleet.knobs.KnobHooks`` seam between ticks.

Mechanics, after "Performance Tuning of Hadoop MapReduce: A Noisy Gradient
Approach" (arXiv:1611.10052):

- **SPSA probing** for ordered integer knobs: a Rademacher ±1 delta on the
  knob's *index* grid, two probe evaluations (plus/minus), the noisy
  gradient estimate :func:`spsa_gradient`, and a sign step whose integer
  magnitude anneals with the classic ``a0/(k+1+A)**alpha`` gain sequence.
  On these few-knob grids the delta is masked to one prior-selected
  coordinate per round ("coordinate SPSA"): the estimator is unchanged,
  the noiseless walk becomes provably exact (each round moves the probed
  knob one step toward its optimum or dead-bands exactly on it), and the
  optimality ledger (``obs.ledger``) slots in as the prior on *which*
  knob to perturb (:meth:`VetTuner.update_prior`).
- **Discounted UCB1 arms** for knobs with no useful index geometry
  (modes, budgets): the objective context drifts while the SPSA knobs
  move, so arm statistics decay (non-stationary bandit) and the knob's
  operating value is the discounted-best arm, re-applied after every
  exploration play.
- **Rollback guard**: every round re-measures the operating point; if it
  regresses beyond ``noise_band`` of the best assignment seen, the tuner
  reverts to that best point through the hooks (and counts the rollback).
  Probes are transient by construction — the guard ensures the *operating*
  point never silently walks off a cliff.
- **Cost-vs-perf frontier**: :func:`elbow_walk` is nes-spark's
  ``extract_opt_conf`` stopping rule (accept a candidate while
  ``perf_inc > cost_inc``, updating the reference) over
  :class:`FrontierPoint` rows, for picking an operating point when knobs
  trade runtime against resource units.

``tune_scenario`` / ``grid_scenario`` drive the loop against
``repro_torch.fleet.scenarios.tunable()`` — the simulator workload with a
known optimum — so "the tuner found the optimum" is a differential test
against exhaustive grid search, not a judgement call.  They default to the
``numpy`` backend, the exact host oracle they are defined on; every
serving path defaults to ``cuda``.  :func:`evaluate_candidate` is the one
candidate-scoring path for a knob assignment's measured times.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..fleet.knobs import Knob, KnobHooks
from ..obs import timed

__all__ = [
    "ElbowResult",
    "FrontierPoint",
    "GridResult",
    "SPSAConfig",
    "TuneCandidate",
    "TuneReport",
    "VetTuner",
    "elbow_walk",
    "evaluate_candidate",
    "grid_scenario",
    "grid_search",
    "objective_from_tick",
    "spsa_gradient",
    "tune_scenario",
]


# --------------------------------------------------- shared candidate scoring
@dataclasses.dataclass
class TuneCandidate:
    """One knob assignment scored on measured times + its vet audit."""

    knobs: Dict
    mean_step_s: float
    vet: float
    ei: float


def evaluate_candidate(knobs: Mapping, times: np.ndarray, *, engine,
                       tracer=None) -> TuneCandidate:
    """Score one assignment from its measured record times.

    Mean step time plus the vet/EI audit from one engine dispatch, under a
    ``tuner.candidate`` span so every evaluation lands on the one tracer
    clock.
    """
    times = np.asarray(times, np.float64)
    with timed(tracer, "tuner.candidate", n=int(times.size),
               **{f"knob.{k}": v for k, v in knobs.items()}):
        r = engine.vet_one(times)
    return TuneCandidate(knobs=dict(knobs), mean_step_s=float(times.mean()),
                         vet=float(r.vet), ei=float(r.ei))


# -------------------------------------------------------------- SPSA pieces
@dataclasses.dataclass(frozen=True)
class SPSAConfig:
    """Gain sequences for the annealed sign step (1611.10052 defaults).

    ``a0/(k+1+A)**alpha`` is the step magnitude before integer rounding
    (floored at one grid step while a move is warranted); ``c0/(k+1)**gamma``
    is the probe radius, rounded to a whole grid step (>= 1).
    """

    a0: float = 2.0
    c0: float = 1.0
    alpha: float = 0.602
    gamma: float = 0.101
    A: float = 5.0

    def step_size(self, k: int) -> int:
        return max(1, int(round(self.a0 / (k + 1 + self.A) ** self.alpha)))

    def probe_radius(self, k: int) -> int:
        return max(1, int(round(self.c0 / (k + 1) ** self.gamma)))


def spsa_gradient(y_plus: float, y_minus: float,
                  plus_idx: Sequence[int],
                  minus_idx: Sequence[int]) -> Tuple[float, ...]:
    """Simultaneous-perturbation gradient estimate on the index grid.

    ``ghat_i = (y+ - y-) / (idx+_i - idx-_i)`` with the *applied* (clipped)
    index span in the denominator, so boundary-clipped probes do not
    inflate the estimate; a component whose span collapsed to zero
    contributes a zero gradient (no information).  On a separable
    quadratic, ``ghat = <grad, delta> * delta`` (elementwise over a ±1
    delta), hence ``<ghat, grad> = <grad, delta>**2 >= 0`` — the descent
    property the hypothesis suite pins.
    """
    plus = np.asarray(plus_idx, np.float64)
    minus = np.asarray(minus_idx, np.float64)
    if plus.shape != minus.shape:
        raise ValueError(f"probe shapes differ: {plus.shape} vs {minus.shape}")
    dy = float(y_plus) - float(y_minus)
    span = plus - minus
    out = np.zeros_like(span)
    np.divide(dy, span, out=out, where=span != 0)
    return tuple(float(g) for g in out)


# ------------------------------------------------------------ tick objective
def objective_from_tick(tick, kind: str = "vet",
                        include: Optional[Sequence] = None) -> float:
    """One scalar objective sample from a ``MuxTick``/``ShardTick``.

    Mean over each stream's *newest* complete window of ``kind``:
    ``"vet"`` (the optimality measure — lower is closer to ideal),
    ``"pr"`` (measured runtime) or ``"ei"`` (estimated ideal).
    ``include`` restricts to those stream ids (per-tenant tuning: pass the
    tenant's streams).  Raises if no included stream has a window yet.
    """
    if kind not in ("vet", "pr", "ei"):
        raise ValueError(f"objective kind must be vet|pr|ei, got {kind!r}")
    newest = [float(getattr(r, kind)[-1]) for sid, r in tick.results.items()
              if r is not None and r.workers > 0
              and (include is None or sid in include)]
    if not newest:
        raise ValueError("no included stream has a complete window yet")
    return float(np.mean(newest))


# ----------------------------------------------------------------- VetTuner
@dataclasses.dataclass(frozen=True)
class PhaseRecord:
    """One completed tuner phase: what was applied, what it measured."""

    round: int
    phase: str  # base | plus | minus | arm
    knob: Optional[str]  # the knob this round perturbs (None before select)
    assignment: Dict
    y: float
    action: str = ""  # "", "move", "hold", "rollback", "arm:<value>"


class _ArmStats:
    """Discounted UCB1 over one bandit knob's arms (non-stationary)."""

    def __init__(self, knob: Knob, discount: float, ucb_c: float):
        self.knob = knob
        self.discount = float(discount)
        self.ucb_c = float(ucb_c)
        self.count = {v: 0.0 for v in knob.values}  # discounted play counts
        self.mean_y = {v: 0.0 for v in knob.values}  # discounted mean obj
        self.plays = 0

    def choose(self):
        """Next arm to play: unseen arms first (grid order), else max UCB
        on the reward ``-y`` with a discounted exploration bonus."""
        for v in self.knob.values:
            if self.count[v] == 0.0:
                return v
        total = sum(self.count.values())
        return max(self.knob.values,
                   key=lambda v: (-self.mean_y[v]
                                  + self.ucb_c * math.sqrt(
                                      math.log(max(total, math.e))
                                      / self.count[v])))

    def record(self, value, y: float) -> None:
        """Decay every arm, then credit this play (discounted running mean)."""
        for v in self.knob.values:
            self.count[v] *= self.discount
        c, m = self.count[value], self.mean_y[value]
        self.count[value] = c + 1.0
        self.mean_y[value] = (m * c + float(y)) / (c + 1.0)
        self.plays += 1

    def best(self):
        """Operating arm: discounted-best mean among played arms (grid-order
        tie-break); first arm before any play."""
        played = [v for v in self.knob.values if self.count[v] > 0.0]
        if not played:
            return self.knob.values[0]
        return min(played, key=lambda v: (self.mean_y[v],
                                          self.knob.index_of(v)))


class VetTuner:
    """Online knob controller over a live vet objective.

    Drive it sample-by-sample: measure the objective at the currently
    applied assignment (one fleet tick — ``objective_from_tick``), call
    :meth:`step` with it, and the tuner advances its phase machine,
    writing the next assignment through ``hooks`` before returning it.
    Each round is:

    1. **base** — ``settle`` samples at the operating point; the rollback
       guard fires here (revert to the best-seen assignment if the base
       regressed beyond ``noise_band``), then the round's knob is selected
       (round-robin, or weighted by the ledger prior).
    2. **plus / minus** — SPSA probes at ``idx ± delta`` for an ordered
       knob, then the annealed sign step (dead-band on an exactly
       symmetric response, which is what the probes return when the knob
       sits on its optimum under a deterministic objective)...
    3. **arm** — ...or one discounted-UCB1 exploration play for a bandit
       knob, after which the operating value snaps back to the
       discounted-best arm.

    ``best`` is the assignment with the lowest *mean* objective over every
    evaluation that touched it (probes included — probing is how the
    optimum is first visited); ``converged`` turns True once the operating
    assignment has been stable for ``patience`` full rounds.
    """

    def __init__(self, hooks: KnobHooks, *, seed: int = 0, settle: int = 1,
                 spsa: Optional[SPSAConfig] = None, noise_band: float = 0.25,
                 dead_band: float = 0.0, patience: int = 3,
                 arm_discount: float = 0.6, ucb_c: float = 0.5,
                 tracer=None):
        if settle < 1:
            raise ValueError(f"settle must be >= 1, got {settle}")
        if not len(hooks):
            raise ValueError("hooks has no knobs registered")
        self.hooks = hooks
        self.spsa = spsa if spsa is not None else SPSAConfig()
        self.settle = int(settle)
        self.noise_band = float(noise_band)
        self.dead_band = float(dead_band)
        self.patience = int(patience)
        self.tracer = tracer
        self._rng = np.random.default_rng(seed)
        self.current: Dict = dict(hooks.snapshot())
        self.weights: Dict[str, float] = {k.name: 1.0 for k in hooks.knobs}
        self._k: Dict[str, int] = {k.name: 0 for k in hooks.knobs}
        self._arms: Dict[str, _ArmStats] = {
            k.name: _ArmStats(k, arm_discount, ucb_c)
            for k in hooks.knobs if k.kind == "bandit"}
        self._stats: Dict[Tuple, Tuple[int, float]] = {}  # key -> (n, mean)
        self._rr = 0  # round-robin cursor (uniform-prior knob selection)
        self._phase = "base"
        self._probe: Dict = {}  # in-flight round scratch
        self._buf: List[float] = []
        self._stable = 0
        self.rounds = 0
        self.rollbacks = 0
        self.history: List[PhaseRecord] = []
        self._apply(self.current)

    # ------------------------------------------------------------- plumbing
    @staticmethod
    def _key(assignment: Mapping) -> Tuple:
        return tuple(sorted(assignment.items()))

    def _record(self, assignment: Mapping, y: float) -> None:
        key = self._key(assignment)
        n, mean = self._stats.get(key, (0, 0.0))
        self._stats[key] = (n + 1, (mean * n + y) / (n + 1))

    @property
    def best(self) -> Tuple[Dict, float]:
        """(assignment, mean objective) with the lowest mean seen so far."""
        if not self._stats:
            return dict(self.current), float("nan")
        key = min(self._stats, key=lambda k: self._stats[k][1])
        return dict(key), self._stats[key][1]

    @property
    def converged(self) -> bool:
        return self._stable >= self.patience

    def update_prior(self, ledger, stage_knobs: Mapping[str, Sequence[str]]
                     ) -> Dict[str, float]:
        """Weight knob selection by the optimality ledger's per-stage
        measured-over-floor ratios (``obs.ledger``): a stage far off its floor votes
        for the knobs mapped to it, so probing effort goes where the
        reducible overhead actually sits.  ``stage_knobs`` maps ledger
        stage names (substring match) to knob names; unmapped knobs keep
        weight 1 so nothing starves.  Returns the new weights."""
        for stage in ledger.stages:
            for pattern, names in stage_knobs.items():
                if pattern in stage.stage:
                    for name in names:
                        if name in self.hooks:
                            self.weights[name] = max(
                                self.weights.get(name, 1.0),
                                float(stage.ratio))
        return dict(self.weights)

    def _select_knob(self) -> Knob:
        """Round's knob: deterministic round-robin under a uniform prior
        (the exactness-proof path), weighted draw once a ledger prior has
        skewed the weights."""
        knobs = self.hooks.knobs
        w = np.array([self.weights[k.name] for k in knobs], np.float64)
        if np.allclose(w, w[0]):
            knob = knobs[self._rr % len(knobs)]
            self._rr += 1
            return knob
        return knobs[int(self._rng.choice(len(knobs), p=w / w.sum()))]

    def _apply(self, assignment: Mapping) -> Dict:
        self._applied = self.hooks.apply(dict(assignment))
        return self._applied

    def _log(self, phase: str, assignment: Mapping, y: float,
             action: str = "") -> None:
        knob = self._probe.get("knob")
        self.history.append(PhaseRecord(
            round=self.rounds, phase=phase,
            knob=knob.name if knob is not None else None,
            assignment=dict(assignment), y=float(y), action=action))

    # ----------------------------------------------------------- the loop
    def step(self, y: float) -> Dict:
        """Feed one objective sample measured at the applied assignment;
        returns the assignment the *next* sample should be measured under.
        """
        self._buf.append(float(y))
        if len(self._buf) < self.settle:
            return dict(self._applied)
        y_bar = float(np.mean(self._buf))
        self._buf = []
        with timed(self.tracer, "tuner.phase", phase=self._phase,
                   round=self.rounds):
            getattr(self, f"_finish_{self._phase}")(y_bar)
        return dict(self._applied)

    def _finish_base(self, y: float) -> None:
        self._record(self.current, y)
        best_knobs, best_y = self.best
        action = ""
        if (self._key(best_knobs) != self._key(self.current)
                and y > best_y * (1.0 + self.noise_band)):
            # Rollback guard: the operating point regressed beyond the
            # noise band — snap back to the best-seen assignment.
            moved = dict(self.current)
            self.current = dict(best_knobs)
            self._apply(self.current)
            self.rollbacks += 1
            self._stable = 0
            action = "rollback"
            self._log("base", moved, y, action)
        else:
            self._log("base", self.current, y, action)
        knob = self._select_knob()
        self._probe = {"knob": knob}
        if knob.kind == "bandit":
            arm = self._arms[knob.name].choose()
            self._probe["arm"] = arm
            self._apply({**self.current, knob.name: arm})
            self._phase = "arm"
            return
        idx = knob.index_of(self.current[knob.name])
        delta = int(self._rng.choice((-1, 1)))
        c = self.spsa.probe_radius(self._k[knob.name])
        plus, minus = knob.clip(idx + c * delta), knob.clip(idx - c * delta)
        if plus == minus:  # single-value grid: nothing to probe
            self._finish_round(moved=False)
            return
        self._probe.update(idx=idx, plus=plus, minus=minus)
        self._apply({**self.current, knob.name: knob.value(plus)})
        self._phase = "plus"

    def _finish_plus(self, y: float) -> None:
        knob = self._probe["knob"]
        probe = {**self.current, knob.name: knob.value(self._probe["plus"])}
        self._record(probe, y)
        self._log("plus", probe, y)
        self._probe["y_plus"] = y
        self._apply({**self.current, knob.name: knob.value(self._probe["minus"])})
        self._phase = "minus"

    def _finish_minus(self, y: float) -> None:
        knob = self._probe["knob"]
        probe = {**self.current, knob.name: knob.value(self._probe["minus"])}
        self._record(probe, y)
        y_plus, y_minus = self._probe["y_plus"], y
        (ghat,) = spsa_gradient(y_plus, y_minus,
                                (self._probe["plus"],), (self._probe["minus"],))
        scale = max(abs(y_plus), abs(y_minus), 1e-30)
        moved = False
        if ghat != 0.0 and abs(y_plus - y_minus) > self.dead_band * scale:
            m = self.spsa.step_size(self._k[knob.name])
            nxt = knob.clip(self._probe["idx"] - m * int(np.sign(ghat)))
            moved = nxt != self._probe["idx"]
            if moved:
                self.current[knob.name] = knob.value(nxt)
        self._k[knob.name] += 1
        self._log("minus", probe, y, "move" if moved else "hold")
        self._finish_round(moved=moved)

    def _finish_arm(self, y: float) -> None:
        knob, arm = self._probe["knob"], self._probe["arm"]
        probe = {**self.current, knob.name: arm}
        self._record(probe, y)
        stats = self._arms[knob.name]
        stats.record(arm, y)
        best_arm = stats.best()
        moved = best_arm != self.current[knob.name]
        self.current[knob.name] = best_arm
        self._k[knob.name] += 1
        self._log("arm", probe, y, f"arm:{arm}")
        self._finish_round(moved=moved)

    def _finish_round(self, *, moved: bool) -> None:
        self._stable = 0 if moved else self._stable + 1
        self.rounds += 1
        self._probe = {"knob": self._probe.get("knob")}
        self._apply(self.current)
        self._phase = "base"

    def report(self) -> Dict:
        """Summary dict (dashboards, benchmarks): best/current assignment,
        round + rollback counts, convergence."""
        best_knobs, best_y = self.best
        return {
            "best": best_knobs, "best_y": best_y,
            "current": dict(self.current), "rounds": self.rounds,
            "rollbacks": self.rollbacks, "converged": self.converged,
            "samples": int(sum(n for n, _ in self._stats.values())),
        }


# --------------------------------------------------------- grid search oracle
@dataclasses.dataclass(frozen=True)
class GridResult:
    """Exhaustive sweep outcome: (assignment, objective) rows, best first."""

    table: Tuple[Tuple[Dict, float], ...]

    @property
    def best(self) -> Tuple[Dict, float]:
        return self.table[0]


def grid_search(hooks: KnobHooks, sample: Callable[[], float],
                *, tracer=None) -> GridResult:
    """Exhaustive oracle: apply every assignment in the knob-grid product,
    measure ``sample()`` under it, return all rows sorted ascending.

    This is what the online tuner is tested *against*: same hooks, same
    objective, every point measured.
    """
    knobs = hooks.knobs
    table = []
    for combo in itertools.product(*(k.values for k in knobs)):
        assignment = {k.name: v for k, v in zip(knobs, combo)}
        hooks.apply(assignment)
        with timed(tracer, "tuner.grid_point",
                   **{f"knob.{k}": v for k, v in assignment.items()}):
            y = float(sample())
        table.append((assignment, y))
    table.sort(key=lambda row: row[1])
    return GridResult(table=tuple(table))


# ------------------------------------------------------- cost-vs-perf elbow
@dataclasses.dataclass(frozen=True)
class FrontierPoint:
    """One frontier candidate: runtime at a knob setting costing ``units``
    resource units (cost = runtime * units, nes-spark's pricing)."""

    knobs: Dict
    runtime: float
    units: float

    @property
    def cost(self) -> float:
        return self.runtime * self.units


@dataclasses.dataclass(frozen=True)
class ElbowResult:
    """Elbow-walk outcome: chosen index/point plus the accepted trail."""

    index: int
    point: FrontierPoint
    trail: Tuple[int, ...]


def elbow_walk(points: Sequence[FrontierPoint]) -> ElbowResult:
    """nes-spark's ``extract_opt_conf`` walk over a candidate frontier.

    Starting from the first point as the reference, scan in candidate
    order and accept a point while its perf gain beats its cost growth —
    ``perf_inc = ref_runtime / runtime`` vs ``cost_inc = cost / ref_cost``
    — updating the reference at each accept (rejected points are skipped,
    not terminal, exactly like the original).  The accepted ``trail`` is
    strictly increasing by construction, and both ratios are invariant to
    uniformly rescaling every runtime (or every cost), so the stopping
    point only depends on the frontier's *shape* — the two invariants the
    property suite pins.  A single candidate is its own elbow.
    """
    if not points:
        raise ValueError("empty frontier")
    ref = points[0]
    trail = [0]
    for i, p in enumerate(points[1:], start=1):
        perf_inc = ref.runtime / p.runtime
        cost_inc = p.cost / ref.cost
        if perf_inc > cost_inc:
            trail.append(i)
            ref = p
    return ElbowResult(index=trail[-1], point=points[trail[-1]],
                       trail=tuple(trail))


# ------------------------------------------------------- scenario harnesses
@dataclasses.dataclass(frozen=True)
class TuneReport:
    """Closed-loop run outcome over a tunable scenario."""

    best: Dict
    best_y: float
    current: Dict
    ticks: int
    rounds: int
    rollbacks: int
    converged: bool
    history: Tuple[PhaseRecord, ...]


def _scenario_mux(scenario, *, engine=None, backend: str = "numpy",
                  tracer=None):
    from ..engine import default_engine
    from ..fleet.mux import VetMux

    eng = engine if engine is not None else default_engine(backend, buckets=64)
    # monitor=False: the tuner's own probes are deliberate regime shifts;
    # the anomaly monitor would flag every one of them.
    mux = VetMux(eng, monitor=False, tracer=tracer)
    for spec in scenario.specs:
        spec.register(mux)
    return mux


def tune_scenario(scenario, *, engine=None, backend: str = "numpy",
                  max_ticks: int = 96, objective: str = "vet",
                  tracer=None, **tuner_kw) -> TuneReport:
    """Run the full closed loop against a ``TunableScenario``: feed one
    chunk set per tick, measure the objective off the ``MuxTick``, and let
    a ``VetTuner`` write knob moves back through the scenario's hooks."""
    mux = _scenario_mux(scenario, engine=engine, backend=backend,
                        tracer=tracer)
    tuner = VetTuner(scenario.hooks(), tracer=tracer, **tuner_kw)
    ticks = 0
    for t in range(max_ticks):
        for sid, chunk in scenario.chunks(t).items():
            mux.feed(sid, chunk)
        y = objective_from_tick(mux.tick(), kind=objective)
        tuner.step(y)
        ticks = t + 1
    best_knobs, best_y = tuner.best
    return TuneReport(best=best_knobs, best_y=best_y,
                      current=dict(tuner.current), ticks=ticks,
                      rounds=tuner.rounds, rollbacks=tuner.rollbacks,
                      converged=tuner.converged,
                      history=tuple(tuner.history))


def grid_scenario(scenario, *, engine=None, backend: str = "numpy",
                  objective: str = "vet", tracer=None) -> GridResult:
    """Exhaustive oracle over a ``TunableScenario``: one tick per grid
    point, same mux/objective path as :func:`tune_scenario`."""
    mux = _scenario_mux(scenario, engine=engine, backend=backend,
                        tracer=tracer)
    hooks = scenario.hooks()
    tick = itertools.count()

    def sample() -> float:
        t = next(tick)
        for sid, chunk in scenario.chunks(t).items():
            mux.feed(sid, chunk)
        return objective_from_tick(mux.tick(), kind=objective)

    return grid_search(hooks, sample, tracer=tracer)
