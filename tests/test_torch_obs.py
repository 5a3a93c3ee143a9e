"""``repro_torch.obs`` (Chrome export, flamegraph, ledger) and
``repro_torch.profiling.recorder`` against the reference's on the same span
trees.  Both tracers run on the counting clock of ``tests/test_obs.py``, so
every timestamp is an exact small float and the outputs must be equal, not
close.  The reference's tracer feeds its metrics registry as it records,
which the port has no copy of; its records are the same either way."""

import json

import numpy as np
import pytest

import repro.obs as ref_obs
import repro.profiling as ref_prof
import repro_torch.obs as port_obs
import repro_torch.profiling as port_prof


def fake_clock(step=1.0):
    """Counting monotonic clock: 0, step, 2*step, ..."""
    state = {"t": -step}

    def clock():
        state["t"] += step
        return state["t"]

    return clock


def build_tree(obs, shape):
    """One span tree per ``shape``; the reference's tracer with a metrics
    registry attached."""
    kw = {"metrics": obs.MetricsRegistry()} if obs is ref_obs else {}
    tr = obs.Tracer(clock=fake_clock(), **kw)
    if shape == "nested":
        with tr.span("tick", rows=3):
            with tr.span("dispatch", bytes=4096, cold=True):
                pass
            with tr.span("commit"):
                pass
    elif shape == "dispatches":
        for k in range(4):
            with tr.span("fleet.tick", shards=2):
                with tr.span("engine.dispatch", bytes=1000 * (k + 1),
                             cold=k == 0):
                    pass
                with tr.span("mux.plan"):
                    pass
    elif shape == "lanes":
        for tid in (0, 1, 2):
            with tr.span("mux.tick", tid=tid):
                with tr.span("engine.dispatch", tid=tid, bytes=64,
                             cold=False):
                    pass
    return tr


def drop_pid_names(records):
    return [tuple(r) for r in records]


@pytest.mark.parametrize("shape", ["nested", "dispatches", "lanes"])
def test_exports_and_ledger_equal_reference(shape, tmp_path):
    ref_tr = build_tree(ref_obs, shape)
    port_tr = build_tree(port_obs, shape)
    assert drop_pid_names(port_tr.records) == drop_pid_names(ref_tr.records)

    ref_chrome = ref_obs.to_chrome(ref_tr.records,
                                   process_names=ref_tr.process_names)
    port_chrome = port_obs.to_chrome(port_tr.records,
                                     process_names=port_tr.process_names)
    assert port_chrome == ref_chrome
    assert port_obs.validate_chrome(port_chrome) == []

    ref_path, port_path = tmp_path / "ref.json", tmp_path / "port.json"
    ref_obs.write_chrome(ref_path, ref_tr)
    port_obs.write_chrome(port_path, port_tr)
    assert port_path.read_text() == ref_path.read_text()
    assert json.loads(port_path.read_text()) == port_chrome

    assert port_obs.flamegraph(port_tr.records) == \
        ref_obs.flamegraph(ref_tr.records)
    ref_led = ref_obs.ledger_from(ref_tr.records)
    port_led = port_obs.ledger_from(port_tr.records)
    assert port_led.to_json() == ref_led.to_json()
    assert port_obs.format_ledger(port_led) == ref_obs.format_ledger(ref_led)


def test_validate_chrome_rejects_what_the_reference_rejects():
    base = {"name": "a", "ph": "X", "ts": 0.0, "dur": 5.0,
            "pid": 0, "tid": 0, "args": {}}
    no_dur = dict(base)
    del no_dur["dur"]
    cases = [[], {"events": []}, {"traceEvents": [no_dur]},
             {"traceEvents": [dict(base, pid="zero")]},
             {"traceEvents": [dict(base, ts=-1.0)]},
             {"traceEvents": [dict(base, ph="B")]},
             {"traceEvents": [dict(base, ts=0.0, dur=10.0),
                              dict(base, name="b", ts=5.0, dur=10.0)]},
             {"traceEvents": [dict(base, ts=0.0, dur=10.0),
                              dict(base, name="b", ts=5.0, dur=10.0, tid=1)]}]
    for obj in cases:
        assert port_obs.validate_chrome(obj) == ref_obs.validate_chrome(obj)


def test_record_profiler_and_phase_timer_match_reference():
    out = []
    for obs, prof in ((ref_obs, ref_prof), (port_obs, port_prof)):
        tr = obs.Tracer(clock=fake_clock(0.5))
        rp = prof.RecordProfiler(unit=2, name="decode", tracer=tr)
        pt = prof.PhaseTimer(tracer=tr)
        for _ in range(7):
            with rp.record():
                pass
        with pt.phase("spill"):
            pass
        out.append((rp.record_times(), rp.unit_times(), rp.unit_times(start=2),
                    pt.totals(), [tuple(r) for r in tr.records]))
    (a_rec, a_units, a_tail, a_tot, a_spans), (b_rec, b_units, b_tail,
                                               b_tot, b_spans) = out
    np.testing.assert_array_equal(b_rec, a_rec)
    np.testing.assert_array_equal(b_units, a_units)
    np.testing.assert_array_equal(b_tail, a_tail)
    assert b_tot == a_tot and b_spans == a_spans
