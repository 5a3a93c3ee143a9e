"""``repro_torch.fleet.shard`` against ``repro.fleet.shard`` on the same
scenarios (the reference's seed-stable bank, fed to both as numpy arrays).

Contracts: placement and budget splits are equal (pure Python, no
arithmetic to round); each stream's window rows have the reference's cut
and agree within 1e-5 (relative), the torch-vs-jax rung of the
differential ladder; the merged ``vet_job`` equals the port's own single
mux to 1e-9 (the merge only reassociates f64 sums) and the reference's to
1e-6 relative (per-stream vets are f32 sums taken in another order).
"""

import numpy as np
import pytest

import repro.fleet as ref_fleet
from repro.fleet import SCENARIOS, build, play
from repro_torch.engine import VetEngine
from repro_torch.fleet import (JobVet, ShardedVetMux, VetMux, job_reduce,
                               merge_job, split_budget)


def port_engine():
    return VetEngine("torch", buckets=64, device="cpu")


@pytest.mark.parametrize("placement", ["pack", "round_robin"])
@pytest.mark.parametrize("scenario", ["churn", "mixed_windows",
                                      "skewed_stragglers"])
def test_placement_matches_reference(placement, scenario):
    sc = build(scenario, n_workers=9, n_ticks=4, seed=1)
    ref = ref_fleet.ShardedVetMux(3, backend="numpy", placement=placement)
    got = ShardedVetMux(3, backend="numpy", placement=placement)
    play(sc, ref)
    play(sc, got)
    assert got.assignment == ref.assignment
    assert [s.streams for s in got.shard_stats] == \
        [s.streams for s in ref.shard_stats]


@pytest.mark.parametrize("budget,demands,weights", [
    (100, [3, 0, 1], None), (8, [10, 10], None), (5, [10, 10], None),
    (8, [2, 10], None), (9, [12, 12], [2.0, 1.0]), (0, [5, 5], None),
    (-3, [5, 5], None), (17, [4, 9, 1, 30], [1.0, 0.5, 3.0, 1.0]),
    (699606058459349848, [699606058459349848] * 4,
     [0.2122188106686006, 0.035734441736370415, 0.6812461849926625,
      0.9997187959452691]),
])
def test_split_budget_matches_reference(budget, demands, weights):
    assert split_budget(budget, demands, weights=weights) == \
        ref_fleet.split_budget(budget, demands, weights=weights)


def test_budgeted_tick_water_fills_like_the_reference():
    ticks = []
    for mod, mux in ((ref_fleet, ref_fleet.ShardedVetMux(2, backend="numpy",
                                                        budget=4)),
                     (None, ShardedVetMux(2, backend="numpy", budget=4))):
        for i in range(4):
            mux.register(i, window=8, stride=4, capacity=256)
        for i in range(4):
            mux.feed(i, np.linspace(1e-3, 2e-3, 40))
        ticks.append(mux.tick())
    ref, got = ticks
    assert got.budgets == ref.budgets == (2, 2)
    assert got.rows == ref.rows and got.deferred == ref.deferred


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_sharded_rows_and_vet_job(scenario):
    sc = build(scenario, n_workers=5, n_ticks=4, seed=7)
    sharded = play(sc, ShardedVetMux(2, engine=port_engine()))
    single = play(sc, VetMux(port_engine()))
    ref = play(sc, ref_fleet.ShardedVetMux(2, backend="numpy"))
    checked = 0
    for k, (got, one, want) in enumerate(zip(sharded, single, ref)):
        assert set(got.results) == set(want.results)
        for sid, r in want.results.items():
            g = got.results[sid]
            assert (g is None) == (r is None), (scenario, k, sid)
            if r is None:
                continue
            np.testing.assert_array_equal(g.t, r.t)
            for name in ("vet", "ei", "oc", "pr"):
                np.testing.assert_allclose(getattr(g, name), getattr(r, name),
                                           rtol=1e-5, atol=0)
        if any(r is not None for r in want.results.values()):
            assert abs(got.vet_job - one.vet_job) <= 1e-9
            assert abs(got.vet_job - want.vet_job) <= 1e-6 * want.vet_job
            checked += 1
    assert checked > 0


def test_merge_job_algebra_and_empty_partials():
    a = JobVet(vet_job=2.0, ei=1.0, oc=1.0, streams=2)
    b = JobVet(vet_job=5.0, ei=1.0, oc=4.0, streams=1)
    assert merge_job([a, None, b]) == ref_fleet.merge_job([
        ref_fleet.JobVet(*a), None, ref_fleet.JobVet(*b)])
    with pytest.raises(ValueError, match="complete window"):
        merge_job([None, None])
    mux = VetMux(VetEngine("numpy", buckets=64))
    mux.register("a", window=8, stride=4)
    mux.feed("a", np.linspace(1e-3, 2e-3, 4))  # below one window
    assert job_reduce(mux.tick()) is None


def test_each_shard_scans_its_rings_in_one_call_per_tick(monkeypatch):
    """A sharded fleet's monitors batch per shard: one change-point call
    per shard on each tick that has due rings."""
    from repro_torch.fleet import anomaly
    calls = []
    real = anomaly.changepoint_ragged

    def counted(values, starts, lengths, *args, **kw):
        calls.append(int(lengths.numel()))
        return real(values, starts, lengths, *args, **kw)

    monkeypatch.setattr(anomaly, "changepoint_ragged", counted)
    mux = ShardedVetMux(2, engine=VetEngine("cuda", buckets=64, device="cpu"),
                        placement="round_robin")
    for i in range(8):
        mux.register(i, window=32, stride=16)
    records = np.random.default_rng(4).pareto(3.0, (8, 32 * 6)) + 1e-3
    per_tick = []
    for k in range(6):
        for i in range(8):
            mux.feed(i, records[i, 32 * k:32 * (k + 1)])
        before = len(calls)
        mux.tick()
        per_tick.append(len(calls) - before)
    # 2k - 1 windows per stream after tick k: rings are due from tick 4
    assert per_tick == [0, 0, 0, 2, 2, 2]
    assert calls == [4] * 6
