"""``repro_torch`` streams, mux and anomaly monitor against ``repro``.

Both packages are fed the same records (numpy, seeded; the anomaly bank's
arrays come from ``repro.fleet.scenarios.build``) and every tick is compared:
rows and counters equal, values under the near-tie contract of
``torch_port_contract``, anomaly flags on the same streams with onsets
within the bank's +/-2-window tolerance.  Fleet snapshots cross between the
packages in both directions.  The batched port backends run on
``device="cpu"``.
"""

import numpy as np
import pytest
import torch

from repro.engine import VetEngine as RefEngine
from repro.engine import VetStream as RefStream
from repro.fleet import ANOMALY_SCENARIOS, build, play
from repro.fleet import AnomalyMonitor as RefMonitor
from repro.fleet import VetMux as RefMux
from repro.fleet import anomaly as ref_anomaly
from repro.fleet.schedule import StreamRequest as RefRequest
from repro.fleet.schedule import plan_tick as ref_plan_tick
from repro_torch.core.changepoint import estimate_changepoint as port_estimate
from repro_torch.engine import VetEngine, VetStream
from repro_torch.fleet import (AnomalyMonitor, StreamRequest, VetMux,
                               plan_tick)
from repro_torch.fleet import anomaly
from repro_torch.kernels import runtime
from repro_torch.kernels.changepoint import changepoint_cuda

from torch_port_contract import assert_contract, sim_matrix

PAIRS = [("numpy", "numpy"), ("torch", "jax"), ("cuda", "pallas")]
TOLERANCE_TICKS = 2


def port_engine(backend, **kw):
    return VetEngine(backend, **({} if backend == "numpy" else
                                 {"device": "cpu"}), **kw)


def first_flags(ticks):
    firsts = {}
    for t in ticks:
        for f in t.flags:
            firsts.setdefault(f.stream_id, f)
    return firsts


def assert_flags_agree(got, want):
    assert set(got) == set(want)
    for sid in want:
        assert abs(got[sid].onset - want[sid].onset) <= TOLERANCE_TICKS


def assert_tick_matches(tick, ref_tick, records, specs, buckets, context):
    """Same rows/dispatch counters; every retained row under the contract."""
    assert tick.rows == ref_tick.rows, context
    assert tick.dispatches == ref_tick.dispatches, context
    assert tick.padded_rows == ref_tick.padded_rows, context
    assert tick.serviced == ref_tick.serviced, context
    assert tick.deferred == ref_tick.deferred, context
    for sid, ref_res in ref_tick.results.items():
        res = tick.results[sid]
        assert (res is None) == (ref_res is None), context
        if ref_res is None:
            continue
        window, stride = specs[sid]
        assert_contract(
            res, ref_res,
            lambda i: records[sid][i * stride:i * stride + window],
            buckets, "log", f"{context} stream {sid}")
        np.testing.assert_array_equal(res.n, ref_res.n)


# ---------------------------------------------------------------- stream
@pytest.mark.parametrize("backend,ref_backend", PAIRS)
@pytest.mark.parametrize("window,stride", [(64, 32), (256, 64)])
def test_stream_ticks_match_reference(backend, ref_backend, window, stride):
    """window 64 takes the fused path on cuda/pallas; 256 is bucketed at 64
    and takes the gather path."""
    records = sim_matrix(1, 6 * window, seed=window)[0]
    port = VetStream(port_engine(backend, buckets=64), window=window,
                     stride=stride)
    ref = RefStream(RefEngine(ref_backend, buckets=64), window=window,
                    stride=stride)
    for k, chunk in enumerate(np.array_split(records, 7)):
        port.feed(chunk)
        ref.feed(chunk)
        got, want = port.tick(), ref.tick()
        assert (got is None) == (want is None)
        if want is not None:
            assert_contract(got, want,
                            lambda i: records[i * stride:i * stride + window],
                            64, "log", f"stream tick {k}")
    assert port.stats == ref.stats
    assert port.engine.dispatches == ref.engine.dispatches
    assert port.engine.dispatch_bytes == ref.engine.dispatch_bytes


def test_numpy_stream_ticks_equal_its_own_sliding_oracle_bitwise():
    eng = VetEngine("numpy", buckets=64)
    records = sim_matrix(1, 700, seed=5)[0]
    st = VetStream(eng, window=96, stride=40, capacity=300)
    fed = 0
    for chunk in np.array_split(records, 9):
        st.feed(chunk)
        fed += chunk.size
        res = st.tick()
        if res is not None:
            want = VetEngine("numpy", buckets=64).vet_sliding(records[:fed],
                                                              96, 40)
            for a, b in zip(res, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend,ref_backend", [("numpy", "numpy"),
                                                 ("cuda", "pallas")])
def test_stream_amend_invalidate_and_snapshot_match_reference(backend,
                                                              ref_backend):
    """amend re-vets exactly the windows that saw the records, invalidate
    every resident one, and a snapshot restores into the other package."""
    records = sim_matrix(1, 400, seed=12)[0]
    port = VetStream(port_engine(backend, buckets=64), window=64, stride=32,
                     capacity=256)
    ref = RefStream(RefEngine(ref_backend, buckets=64), window=64, stride=32,
                    capacity=256)
    for st in (port, ref):
        st.feed(records[:300])
        st.tick()
        st.amend(250, [5e-3, 6e-3])
    assert port.pending_windows == ref.pending_windows
    fixed = records[:300].copy()
    fixed[250:252] = [5e-3, 6e-3]
    window = lambda i: fixed[i * 32:i * 32 + 64]
    assert_contract(port.tick(), ref.tick(), window, 64, "log", "amend")
    assert port.invalidate() == ref.invalidate()
    assert_contract(port.tick(), ref.tick(), window, 64, "log", "invalidate")
    assert port.stats == ref.stats
    moved = RefStream.from_state(RefEngine(ref_backend, buckets=64),
                                 port.state_dict())
    back = VetStream.from_state(port_engine(backend, buckets=64),
                                ref.state_dict())
    for restored, origin in ((moved, port), (back, ref)):
        for x, y in zip(restored.collect(), origin.collect()):
            np.testing.assert_array_equal(x, y)
        assert restored.stats == origin.stats
        assert restored.pending_windows == origin.pending_windows


# ------------------------------------------------------------------- mux
def drive(mux_port, mux_ref, specs, records, ticks, buckets):
    for sid, (w, s) in specs.items():
        mux_port.register(sid, window=w, stride=s, capacity=4 * w)
        mux_ref.register(sid, window=w, stride=s, capacity=4 * w)
    for k in range(ticks):
        for sid, (w, _) in specs.items():
            chunk = records[sid][k * w:(k + 1) * w]
            mux_port.feed(sid, chunk)
            mux_ref.feed(sid, chunk)
        tick, ref_tick = mux_port.tick(), mux_ref.tick()
        assert_tick_matches(tick, ref_tick, records, specs, buckets,
                            f"mux tick {k}")
    assert mux_port.stats == mux_ref.stats


@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_mux_fused_path_matches_reference(backend, ref_backend):
    """Mixed windows < 4*buckets: one fused launch per tick on cuda."""
    specs = {f"w{i}": (w, w // 2) for i, w in enumerate([64, 96, 128] * 2)}
    records = {sid: sim_matrix(1, 5 * w, seed=i)[0]
               for i, (sid, (w, _)) in enumerate(specs.items())}
    port = VetMux(port_engine(backend, buckets=64), monitor=False)
    ref = RefMux(RefEngine(ref_backend, buckets=64), monitor=False)
    drive(port, ref, specs, records, 5, 64)
    if backend == "cuda":
        assert port.stats.dispatches == port.stats.ticks == 5


@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_mux_gather_path_matches_reference(backend, ref_backend):
    """Windows >= 4*buckets are bucketed and coalesced on the gather path:
    one dispatch per window length per tick, pow2 padding counted."""
    specs = {f"w{i}": (w, w // 2) for i, w in enumerate([256, 256, 256,
                                                          160, 256])}
    records = {sid: sim_matrix(1, 4 * w, seed=10 + i)[0]
               for i, (sid, (w, _)) in enumerate(specs.items())}
    port = VetMux(port_engine(backend, buckets=40), monitor=False)
    ref = RefMux(RefEngine(ref_backend, buckets=40), monitor=False)
    drive(port, ref, specs, records, 4, 40)
    assert port.stats.padded_rows == ref.stats.padded_rows


@pytest.mark.parametrize("name", ["mixed_windows", "churn", "bursty"])
def test_scenario_bank_plays_identically(name):
    """A reference scenario's arrays through both muxes (cuda on the CPU
    against pallas): every tick's rows, counters and values."""
    sc = build(name, n_workers=5, n_ticks=5, seed=7)
    specs = {s.stream_id: (s.window, s.stride) for s in sc.specs}
    specs.update({s.stream_id: (s.window, s.stride)
                  for e in sc.events for s in e.joins})
    records = {sid: np.concatenate(
        [e.chunks[sid] for e in sc.events if sid in e.chunks])
        for sid in specs}
    port = VetMux(port_engine("cuda", buckets=64), monitor=False)
    ref = RefMux(RefEngine("pallas", buckets=64), monitor=False)
    a = play(sc, port)
    b = play(build(name, n_workers=5, n_ticks=5, seed=7), ref)
    for k, (x, y) in enumerate(zip(a, b)):
        assert_tick_matches(x, y, records, specs, 64, f"{name} tick {k}")
    assert port.stats == ref.stats


# --------------------------------------------------------------- anomaly
@pytest.mark.parametrize("method", ["numpy", "torch", "cuda"])
@pytest.mark.parametrize("name", sorted(ANOMALY_SCENARIOS))
def test_anomaly_bank_flags_match_reference(name, method):
    """The bank's arrays through both packages: the port's monitor (each
    method) flags exactly the affected streams, within +/-2 windows of the
    injected onset, on the same streams as the reference's numpy monitor."""
    sc = build(name, seed=1)
    port = VetMux(VetEngine("numpy", buckets=64),
                  monitor=AnomalyMonitor(method, device="cpu"))
    ref = RefMux(RefEngine("numpy", buckets=64),
                 monitor=RefMonitor("numpy"))
    got, want = first_flags(play(sc, port)), first_flags(play(sc, ref))
    assert set(got) == set(sc.affected)
    for sid in sc.affected:
        assert abs(got[sid].onset - sc.onset_tick) <= TOLERANCE_TICKS
    assert_flags_agree(got, want)
    assert port.stats.anomalies >= len(sc.affected)


def test_monitor_methods_and_defaults():
    with pytest.raises(ValueError, match="method"):
        AnomalyMonitor("jax")
    for backend in ("numpy", "torch", "cuda"):
        mux = VetMux(port_engine(backend, buckets=64))
        assert mux.monitor.method == backend
        assert mux.monitor._device_arg == mux.engine._device_arg
    assert VetMux(VetEngine("numpy"), monitor=False).monitor is None


def test_monitor_unit_step_flag():
    mon = AnomalyMonitor("cuda", device="cpu", min_points=8)
    series = np.concatenate([np.full(6, 1.2), np.full(6, 3.0)])
    assert mon.observe("w0", series[:10], first=0) == ()
    assert mon.observe("w0", series[:11], first=0) == ()
    (flag,) = mon.observe("w0", series, first=0)
    assert (flag.onset, flag.pre < flag.post, mon.raised) == (6, True, 1)


class _PerRingMonitor(AnomalyMonitor):
    """The monitor cutting one ring per call through the port's per-row
    estimators (``core.estimate_changepoint`` for ``torch``, the dense
    ``changepoint_cuda`` entry for ``cuda``): the per-stream oracle a
    batched tick must reproduce."""

    def _argmins(self, zs):
        est = port_estimate if self.method == "torch" else changepoint_cuda
        return [int(est(torch.from_numpy(np.asarray(z, np.float32)),
                        omega=self.omega)) for z in zs]


@pytest.mark.parametrize("method", ["torch", "cuda"])
@pytest.mark.parametrize("name", sorted(ANOMALY_SCENARIOS))
def test_batched_tick_equals_observing_stream_by_stream(name, method):
    """A mux tick scans its due rings together; a monitor fed the same
    streams one at a time through ``observe``, cutting each ring on its own
    with the per-row estimator, raises exactly the same flags (values
    included) on every tick and ends in the same state."""
    batched = AnomalyMonitor(method, device="cpu")
    solo = _PerRingMonitor(method, device="cpu")
    tick_call = batched._observe_tick
    sizes = []

    def spy(batch):
        flags = tick_call(batch)
        one_by_one = tuple(
            f for sid, vets, first, tenant in batch
            for f in solo.observe(sid, vets, first=first, tenant=tenant))
        assert flags == one_by_one
        sizes.append(len(batch))
        return flags

    batched._observe_tick = spy
    mux = VetMux(VetEngine("numpy", buckets=64), monitor=batched)
    ticks = play(build(name, seed=1), mux)
    assert max(sizes) > 1 and len(sizes) == len(ticks)
    assert batched.raised == solo.raised == sum(len(t.flags) for t in ticks)
    assert batched.raised > 0
    assert batched.state_dict() == solo.state_dict()


@pytest.mark.parametrize("method,entry", [("cuda", "changepoint_ragged"),
                                          ("torch",
                                           "changepoint_ragged_plain")])
def test_one_changepoint_call_per_mux_tick(monkeypatch, method, entry):
    """Every due stream of a tick shares one change-point call."""
    calls = []
    real = getattr(anomaly, entry)

    def counted(values, starts, lengths, *args, **kw):
        calls.append(int(lengths.numel()))
        return real(values, starts, lengths, *args, **kw)

    monkeypatch.setattr(anomaly, entry, counted)
    mux = VetMux(VetEngine("numpy", buckets=64),
                 monitor=AnomalyMonitor(method, device="cpu"))
    for i in range(12):
        mux.register(i, window=32, stride=16)
    records = sim_matrix(12, 32 * 8, seed=21)
    per_tick = []
    for k in range(8):
        for i in range(12):
            mux.feed(i, records[i, 32 * k:32 * (k + 1)])
        before = len(calls)
        mux.tick()
        per_tick.append(len(calls) - before)
    # windows per stream after tick k: 2k - 1; rings scan from 6 (tick 4)
    assert per_tick == [0, 0, 0, 1, 1, 1, 1, 1]
    assert calls == [12] * 5


def test_ring_gates_equal_the_reference_per_ring_formulas():
    """The monitor's f64 gates are the reference's per-ring formulas bit for
    bit (SSE landscape, null-model SSE), and the ``numpy`` method's cuts are
    the landscape's argmin ring by ring."""
    rng = np.random.default_rng(3)
    rings = np.exp(rng.normal(0.0, 0.3, (50, 24))
                   + np.where(np.arange(24) >= 14, 1.0, 0.0))
    zs = list(np.log(rings))
    t = AnomalyMonitor("numpy")._argmins(zs)
    for i, z in enumerate(zs):
        sse = ref_anomaly._closed_form_scan_f64(z, 3)
        np.testing.assert_array_equal(anomaly._closed_form_scan_f64(z, 3),
                                      sse)
        assert anomaly._single_segment_sse_f64(z) == \
            ref_anomaly._single_segment_sse_f64(z)
        assert t[i] == int(np.argmin(sse)) + 1


# ------------------------------------------------------------ state dicts
def _split_play(sc, first, second, cut):
    """Play ``sc`` on ``first`` up to tick ``cut``, move its snapshot into
    ``second`` and play the rest there."""
    for spec in sc.specs:
        spec.register(first)
    out = []
    for k, event in enumerate(sc.events):
        mux = first if k < cut else second
        if k == cut:
            second.load_state_dict(first.state_dict())
        for spec in event.joins:
            spec.register(mux)
        for sid, chunk in event.chunks.items():
            mux.feed(sid, chunk)
        out.append(mux.tick())
        for sid in event.leaves:
            mux.deregister(sid)
    return out


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_fleet_snapshot_crosses_packages(direction):
    """A fleet checkpointed by one package continues in the other: the same
    keys, no window re-vetted, counters and flags carried over."""
    sc = build("contention_onset", seed=1)
    ref_run = play(sc, RefMux(RefEngine("numpy", buckets=64)))
    port_mux = VetMux(VetEngine("numpy", buckets=64))
    ref_mux = RefMux(RefEngine("numpy", buckets=64))
    first, second = ((ref_mux, port_mux) if direction == "ref_to_port"
                     else (port_mux, ref_mux))
    split = _split_play(build("contention_onset", seed=1), first, second, 8)
    assert second.stats.ticks == len(sc.events)
    assert second.stats.rows == sum(t.rows for t in ref_run)
    assert second.stats.dispatches == sum(t.dispatches for t in ref_run)
    for k, (a, b) in enumerate(zip(split, ref_run)):
        assert (a.rows, a.serviced) == (b.rows, b.serviced), k
    assert_flags_agree(first_flags(split), first_flags(ref_run))


def test_snapshot_keys_are_the_reference_keys():
    port, ref = VetMux(VetEngine("numpy", buckets=64)), RefMux(
        RefEngine("numpy", buckets=64))
    for mux in (port, ref):
        mux.register("a", window=32, stride=16)
        mux.feed("a", np.linspace(1e-3, 2e-3, 80))
        mux.tick()
    a, b = port.state_dict(), ref.state_dict()

    def keys(x):
        if isinstance(x, dict):
            return {k: keys(v) for k, v in x.items()}
        if isinstance(x, list):
            return [keys(v) for v in x]
        return type(x).__name__

    assert keys(a) == keys(b)


# ---------------------------------------------------------------- planner
def test_plan_tick_matches_reference():
    rng = np.random.default_rng(0)
    for trial in range(20):
        reqs = [dict(stream_id=f"s{i}", pending=int(rng.integers(0, 9)),
                     priority=float(rng.integers(0, 3)),
                     tenant=str(rng.choice(["a", "b", "c"])),
                     staleness=int(rng.integers(0, 4)),
                     headroom=int(rng.integers(-1, 5))) for i in range(12)]
        kw = dict(budget=int(rng.integers(1, 40)),
                  tenant_weights={"a": 2.0}, urgent_headroom=0)
        got = plan_tick([StreamRequest(**r) for r in reqs], **kw)
        want = ref_plan_tick([RefRequest(**r) for r in reqs], **kw)
        assert got == want


def test_cuda_mux_without_a_card_raises_at_first_tick(monkeypatch):
    monkeypatch.delenv(runtime.ENV_VAR, raising=False)
    assert VetMux().engine.backend == "cuda"
    mux = VetMux(VetEngine(buckets=64))
    assert mux.monitor.method == "cuda"
    mux.register("a", window=32, stride=16)
    mux.feed("a", np.linspace(1e-3, 2e-3, 64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mux.tick()
