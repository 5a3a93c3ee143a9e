"""``repro_torch.fleet.knobs`` and ``repro_torch.sched.tuner`` against the
reference (``repro.fleet.knobs``, ``repro.sched.tuner``).

- The knob seam: validation, all-or-nothing apply, snapshot round trip,
  and ``mux_knob_hooks`` writing the driver-side budget of ``VetMux``,
  ``ShardedVetMux`` and ``TransportVetMux`` alike.
- The tuner's trajectory: the port's and the reference's ``VetTuner``,
  the same seed over the same knob grids, driven by one deterministic
  synthetic objective of the assignment, walk identical phase, assignment
  and action sequences (the phase machine is host Python and numpy; the
  seeded ``default_rng`` draws are the reference's).
- Recoverability: the port's ``tune_scenario(tunable())`` reaches the
  designed optimum ``{n_micro: 4, q_chunk: 32, io_mode: 1}`` on the
  ``numpy`` and ``torch`` backends and equals the port's grid oracle.
"""

import json
import types

import numpy as np
import pytest

import repro.fleet.knobs as ref_knobs
import repro.sched.tuner as ref_tuner
import repro_torch.fleet.knobs as port_knobs
from repro.engine import VetEngine as RefVetEngine
from repro.fleet import tunable as ref_tunable
from repro_torch.engine import VetEngine
from repro_torch.fleet import (Knob, KnobHooks, ShardedVetMux,
                               TransportVetMux, VetMux, mux_knob_hooks,
                               tunable)
from repro_torch.obs import Tracer, validate_chrome, write_chrome
from repro_torch.obs.ledger import LedgerReport, StageLedger
from repro_torch.sched import (FrontierPoint, SPSAConfig, VetTuner,
                               elbow_walk, evaluate_candidate, grid_scenario,
                               grid_search, objective_from_tick,
                               spsa_gradient, tune_scenario)

from torch_port_contract import RTOL

OPTIMUM = {"n_micro": 4, "q_chunk": 32, "io_mode": 1}


def engine(backend):
    return VetEngine(backend, buckets=64, device="cpu")


def synthetic(assignment, knobs):
    """A deterministic objective of the assignment alone: the tunable
    envelope with a fixed pseudo-random ripple per grid point, so probes,
    moves, holds, arms and rollbacks all occur."""
    idx = [k.index_of(assignment[k.name]) for k in knobs]
    opt = [k.index_of(OPTIMUM[k.name]) for k in knobs]
    y = 1.0
    for k, i, o in zip(knobs, idx, opt):
        y *= (1.0 + 0.4 * abs(i - o)) if k.kind == "spsa" else \
            (1.55, 1.0, 1.3)[i]
    ripple = (sum((7 + 3 * j) * i for j, i in enumerate(idx)) * 0.618) % 1.0
    return y * (1.0 + 0.35 * ripple)


def grids(module):
    return (module.Knob("n_micro", (1, 2, 4, 8)),
            module.Knob("q_chunk", (16, 32, 64, 128)),
            module.Knob("io_mode", (0, 1, 2), kind="bandit"))


def ledger_like(ratio):
    """What ``update_prior`` reads of a ledger, for both packages."""
    stage = types.SimpleNamespace(stage="engine.dispatch", ratio=ratio)
    return types.SimpleNamespace(stages=(stage,))


# ------------------------------------------------------------ knob seam
def test_knob_validation_and_grid_arithmetic():
    for bad in (dict(name="empty", values=()),
                dict(name="dup", values=(1, 1)),
                dict(name="bad", values=(1, 2), kind="genetic")):
        with pytest.raises(ValueError):
            Knob(**bad)
        with pytest.raises(ValueError):
            ref_knobs.Knob(**bad)
    k, r = Knob("q", (16, 32, 64)), ref_knobs.Knob("q", (16, 32, 64))
    assert (k.index_of(32), k.value(2), k.clip(9), k.clip(-4)) == \
           (r.index_of(32), r.value(2), r.clip(9), r.clip(-4)) == (1, 64, 2, 0)
    with pytest.raises(ValueError):
        k.index_of(48)


def test_hooks_apply_is_all_or_nothing():
    state = {"a": 1, "b": 10}
    hooks = KnobHooks.over_state((Knob("a", (1, 2)), Knob("b", (10, 20))),
                                 state)
    with pytest.raises(KeyError):
        hooks.apply({"a": 2, "nope": 1})
    with pytest.raises(ValueError):
        hooks.apply({"a": 2, "b": 99})
    assert state == {"a": 1, "b": 10}  # nothing written by either
    assert hooks.apply({"a": 2}) == {"a": 2}
    assert hooks.snapshot() == {"a": 2, "b": 10}
    assert "a" in hooks and len(hooks) == 2
    with pytest.raises(ValueError):
        hooks.register(Knob("a", (1,)), lambda v: None, lambda: 1)
    with pytest.raises(KeyError):
        hooks.knob("c")


@pytest.mark.parametrize("kind", ["single", "sharded", "transport"])
def test_mux_knob_hooks_write_the_live_budget(kind):
    eng = engine("numpy")
    if kind == "single":
        mux = VetMux(eng, monitor=False)
    elif kind == "sharded":
        mux = ShardedVetMux(2, engine=eng)
    else:
        mux = TransportVetMux(2, engine=eng, driver="inprocess")
    hooks = mux_knob_hooks(mux, budget_values=(8, 16, 32))
    assert hooks.snapshot() == {"tick_budget": 32}  # None: loosest arm
    hooks.apply({"tick_budget": 16})
    assert mux.budget == 16 and hooks.snapshot() == {"tick_budget": 16}
    assert hooks.knob("tick_budget").kind == "bandit"
    mux.register("a", window=8, stride=4, capacity=256)
    mux.feed("a", np.linspace(1e-3, 2e-3, 100))  # 24 windows pending
    tick = mux.tick()
    assert tick.rows == 16 and sum(tick.deferred.values()) == 8
    if kind == "transport":
        mux.close()
    with pytest.raises(ValueError):
        mux_knob_hooks(VetMux(eng, monitor=False), budget_values=(0, 8))


# ------------------------------------------------- trajectory differential
@pytest.mark.parametrize("seed,settle,prior", [(0, 1, None), (3, 1, None),
                                               (1, 2, None), (5, 1, 8.0)])
def test_trajectory_equals_the_reference(seed, settle, prior):
    """Same seed, same grids, one objective: identical histories."""
    states = [{k.name: k.values[0] for k in grids(ref_knobs)}
              for _ in range(2)]
    port = VetTuner(KnobHooks.over_state(grids(port_knobs), states[0]),
                    seed=seed, settle=settle)
    ref = ref_tuner.VetTuner(ref_knobs.KnobHooks.over_state(
        grids(ref_knobs), states[1]), seed=seed, settle=settle)
    if prior is not None:
        mapping = {"engine.dispatch": ("q_chunk",)}
        assert port.update_prior(ledger_like(prior), mapping) == \
            ref.update_prior(ledger_like(prior), mapping)
    knobs = port.hooks.knobs
    for _ in range(240):
        a, b = port.step(synthetic(states[0], knobs)), \
            ref.step(synthetic(states[1], knobs))
        assert a == b and states[0] == states[1]
    assert [tuple(vars(h).values()) for h in port.history] == \
           [tuple(vars(h).values()) for h in ref.history]
    assert port.report() == ref.report()
    assert {h.phase for h in port.history} >= {"base", "plus", "minus",
                                              "arm"}
    assert port.rollbacks == ref.rollbacks


def test_spsa_pieces_equal_the_reference():
    cfg, rcfg = SPSAConfig(), ref_tuner.SPSAConfig()
    assert [(cfg.step_size(k), cfg.probe_radius(k)) for k in range(40)] == \
           [(rcfg.step_size(k), rcfg.probe_radius(k)) for k in range(40)]
    for yp, ym, plus, minus in [(2.0, 1.0, (3, 1), (1, 3)),
                                (1.0, 1.0, (2,), (0,)),
                                (5.0, 2.5, (2, 2), (2, 0))]:
        assert spsa_gradient(yp, ym, plus, minus) == \
            ref_tuner.spsa_gradient(yp, ym, plus, minus)
    with pytest.raises(ValueError):
        spsa_gradient(1.0, 0.0, (1, 2), (0,))


def test_elbow_walk_and_grid_search_equal_the_reference():
    rng = np.random.default_rng(9)
    rows = [(float(rt), float(u)) for rt, u in zip(
        np.sort(rng.uniform(1, 10, 12))[::-1], np.arange(1, 13))]
    got = elbow_walk([FrontierPoint({"i": i}, rt, u)
                      for i, (rt, u) in enumerate(rows)])
    ref = ref_tuner.elbow_walk([ref_tuner.FrontierPoint({"i": i}, rt, u)
                                for i, (rt, u) in enumerate(rows)])
    assert (got.index, got.trail) == (ref.index, ref.trail)
    with pytest.raises(ValueError):
        elbow_walk([])
    states = [{k.name: k.values[0] for k in grids(ref_knobs)}
              for _ in range(2)]
    hooks = KnobHooks.over_state(grids(port_knobs), states[0])
    rhooks = ref_knobs.KnobHooks.over_state(grids(ref_knobs), states[1])
    g = grid_search(hooks, lambda: synthetic(states[0], hooks.knobs))
    r = ref_tuner.grid_search(rhooks, lambda: synthetic(states[1],
                                                        hooks.knobs))
    assert g.table == r.table and len(g.table) == 48


# ------------------------------------------------------- recoverability
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_tune_scenario_reaches_the_designed_optimum(backend):
    grid = grid_scenario(tunable(seed=0), engine=engine(backend))
    rep = tune_scenario(tunable(seed=0), engine=engine(backend),
                        max_ticks=96, seed=0)
    assert grid.best[0] == OPTIMUM
    assert rep.best == rep.current == OPTIMUM and rep.converged
    assert rep.best_y == pytest.approx(grid.best[1], rel=1e-12)


def test_tune_scenario_walks_the_reference_walk():
    """The port's numpy oracle and the reference's differ in f32 rounding
    only: the same phase/assignment walk, objectives to the f32 rung."""
    got = tune_scenario(tunable(seed=0), max_ticks=48, seed=0)
    ref = ref_tuner.tune_scenario(ref_tunable(seed=0), max_ticks=48, seed=0)
    assert [(h.round, h.phase, h.knob, h.assignment, h.action)
            for h in got.history] == \
           [(h.round, h.phase, h.knob, h.assignment, h.action)
            for h in ref.history]
    np.testing.assert_allclose([h.y for h in got.history],
                               [h.y for h in ref.history], rtol=RTOL)
    assert (got.best, got.rounds, got.rollbacks) == \
           (ref.best, ref.rounds, ref.rollbacks)


def test_objective_from_tick_kinds_and_include():
    sc = tunable(seed=0)
    mux = VetMux(engine("numpy"), monitor=False)
    for spec in sc.specs:
        spec.register(mux)
    for sid, chunk in sc.chunks(0).items():
        mux.feed(sid, chunk)
    tick = mux.tick()
    vet, pr, ei = (objective_from_tick(tick, k) for k in ("vet", "pr", "ei"))
    assert vet >= 1.0 and pr > ei > 0
    assert vet == pytest.approx(tick.vet_job)
    assert objective_from_tick(tick, "vet", include=("w0000",)) == \
        float(tick.results["w0000"].vet[-1])
    with pytest.raises(ValueError):
        objective_from_tick(tick, "latency")
    with pytest.raises(ValueError):
        objective_from_tick(tick, "vet", include=("absent",))


def test_ledger_prior_biases_knob_selection():
    hooks = KnobHooks.over_state(
        (Knob("hot", (1, 2, 4)), Knob("cold", (1, 2, 4))),
        {"hot": 1, "cold": 1})
    tuner = VetTuner(hooks, seed=0)
    stage = StageLedger("engine.dispatch", 10, 1.0, 0, 0.01, 50.0)
    report = LedgerReport(stages=(stage,), measured_s=1.0, floor_s=0.01,
                          ratio=50.0)
    weights = tuner.update_prior(report, {"engine.dispatch": ("hot",)})
    assert weights == {"hot": 50.0, "cold": 1.0}
    for _ in range(200):
        tuner.step(1.0)
    picked = [r.knob for r in tuner.history if r.phase == "minus"]
    assert picked.count("hot") > 3 * picked.count("cold")


def test_tuner_spans_in_a_chrome_trace(tmp_path):
    tracer = Tracer()
    times = np.linspace(1e-3, 2e-3, 64)
    cand = evaluate_candidate({"n_micro": 2}, times, engine=engine("numpy"),
                              tracer=tracer)
    ref = ref_tuner.evaluate_candidate(
        {"n_micro": 2}, times,
        engine=RefVetEngine("numpy", buckets=64))
    assert cand.knobs == ref.knobs and cand.mean_step_s == ref.mean_step_s
    np.testing.assert_allclose([cand.vet, cand.ei], [ref.vet, ref.ei],
                               rtol=RTOL)
    tune_scenario(tunable(seed=0), engine=engine("numpy"), max_ticks=12,
                  seed=0, tracer=tracer)
    path = tmp_path / "tuner.json"
    write_chrome(str(path), tracer)
    trace = json.loads(path.read_text())
    assert validate_chrome(trace) == []
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert {"tuner.candidate", "tuner.phase"} <= names


def test_tuner_refuses_bad_settings():
    hooks = KnobHooks.over_state((Knob("a", (1, 2)),), {"a": 1})
    with pytest.raises(ValueError, match="settle"):
        VetTuner(hooks, settle=0)
    with pytest.raises(ValueError, match="no knobs"):
        VetTuner(KnobHooks())
