"""``repro_torch.fleet.scenarios`` against ``repro.fleet.scenarios``.

Both packages build every bank scenario and the tunable scenario from the
same seed; the host-side generators draw from ``numpy.random.default_rng``
and the simulator in the same order, so every array, spec and event must be
equal (arrays bit for bit).  The pinned ``ANOMALY_GOLDENS`` hashes of the
reference suite are not checked here.
"""

import numpy as np
import pytest

import repro.fleet.scenarios as ref_sc
from repro.engine import VetEngine as RefVetEngine
from repro.fleet import VetMux as RefVetMux
from repro_torch.engine import VetEngine
from repro_torch.fleet import (ANOMALY_SCENARIOS, SCENARIOS, TunableScenario,
                               VetMux, build, play, tunable)

from torch_port_contract import RTOL


def assert_same_scenario(got, ref):
    assert got.name == ref.name
    assert got.onset_tick == ref.onset_tick
    assert got.affected == ref.affected
    assert got.n_streams == ref.n_streams
    assert [vars(s) for s in got.specs] == [vars(s) for s in ref.specs]
    assert len(got.events) == len(ref.events)
    for k, (a, b) in enumerate(zip(got.events, ref.events)):
        assert list(a.chunks) == list(b.chunks), k
        for sid in b.chunks:
            assert a.chunks[sid].dtype == b.chunks[sid].dtype
            np.testing.assert_array_equal(a.chunks[sid], b.chunks[sid],
                                          err_msg=f"tick {k} {sid}")
        assert [vars(s) for s in a.joins] == [vars(s) for s in b.joins], k
        assert a.leaves == b.leaves, k


def test_the_banks_name_the_same_scenarios():
    assert list(SCENARIOS) == list(ref_sc.SCENARIOS)
    assert list(ANOMALY_SCENARIOS) == list(ref_sc.ANOMALY_SCENARIOS)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_bank_scenario_equals_the_reference(name):
    assert_same_scenario(build(name), ref_sc.build(name))


@pytest.mark.parametrize("name", ["bursty", "churn", "mixed_windows",
                                  "hetero_tiers"])
def test_resized_scenario_equals_the_reference(name):
    kw = dict(n_workers=11, n_ticks=9, seed=23)
    assert_same_scenario(build(name, **kw), ref_sc.build(name, **kw))


def test_build_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown scenario"):
        build("tunable")


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_tunable_equals_the_reference(noise):
    got, ref = tunable(noise=noise, seed=4), ref_sc.tunable(noise=noise,
                                                            seed=4)
    assert isinstance(got, TunableScenario)
    assert [vars(s) for s in got.specs] == [vars(s) for s in ref.specs]
    assert got.state == ref.state and got.optimum == ref.optimum
    assert [(k.name, k.values, k.kind) for k in got.knobs] == \
           [(k.name, k.values, k.kind) for k in ref.knobs]
    moves = [{}, {"n_micro": 4}, {"q_chunk": 32, "io_mode": 2},
             {"io_mode": 1}]
    for tick, move in enumerate(moves):
        got.hooks().apply(move)
        ref.hooks().apply(move)
        assert got.envelope() == ref.envelope()
        a, b = got.chunks(tick), ref.chunks(tick)
        assert list(a) == list(b)
        for sid in b:
            np.testing.assert_array_equal(a[sid], b[sid])
    got.reset()
    assert got.state == {k.name: k.values[0] for k in got.knobs}


def test_tunable_envelope_is_one_exactly_at_the_optimum():
    sc = tunable()
    assert sc.envelope(sc.optimum) == 1.0
    assert sc.envelope() > 1.0  # the starting corner


def test_play_drives_a_mux_like_the_reference():
    sc = build("churn", n_workers=6, n_ticks=6, seed=2)
    got = play(sc, VetMux(VetEngine("numpy", buckets=64)))
    ref = ref_sc.play(ref_sc.build("churn", n_workers=6, n_ticks=6, seed=2),
                      RefVetMux(RefVetEngine("numpy", buckets=64)))
    assert [(t.rows, t.serviced) for t in got] == \
           [(t.rows, t.serviced) for t in ref]
    # the f32 pipeline's rung of the ladder (torch_port_contract.RTOL)
    assert [t.vet_job for t in got[1:]] == pytest.approx(
        [t.vet_job for t in ref[1:]], rel=RTOL)
