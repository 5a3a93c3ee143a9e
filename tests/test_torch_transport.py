"""``repro_torch.fleet.transport`` (the fleet across worker processes).

Rungs of the differential ladder held here:

1. the port's in-process driver against the port's ``ShardedVetMux`` on
   three scenarios of the bank, tick for tick: schedule decisions,
   counters, newest-window rows and retained rows exactly equal (the same
   code on the same CPU);
2. the port's process driver against its in-process driver (real pipes,
   spawned workers, pickling): exactly equal;
3. the process driver with a worker killed before and in the middle of a
   tick: checkpoint + journal resume counts each tick exactly once
   (lifetime row and dispatch counters equal the oracle's);
4. the port against ``repro.fleet.TransportVetMux(driver="inprocess")``:
   placement, budget splits and counters equal, rows under
   ``torch_port_contract.assert_contract`` (the torch-vs-reference rung).

Also: the ``ShardHandle`` retry/backoff/journal units on a fake channel,
replies holding host values only (no ``torch.Tensor`` crosses a pipe), the
parent's device policy seeded into each worker (``REPRO_TORCH_DEVICE``
wins), and a worker without a card raising ``RuntimeError`` driver-side,
unretried.  Process spawns are few (each imports torch): four fleets.
"""

import inspect
import pickle

import numpy as np
import pytest
import torch

import repro.fleet as ref_fleet
from repro_torch.engine import BatchVetResult, VetEngine, VetStream
from repro_torch.fleet import (EngineSpec, ShardedVetMux, TransportError,
                               TransportVetMux, build)
from repro_torch.fleet.transport import (FAULT_EXIT, ShardWorker, TickReply,
                                         WorkerFault, shard_worker_main)
from repro_torch.fleet.transport.driver import ShardHandle, _TransportFailure
from repro_torch.kernels import runtime
from repro_torch.obs import Tracer

from torch_port_contract import assert_contract

PROCESS_KW = dict(driver="process", timeout=60.0, backoff_base=0.01)


def cpu_engine(backend="cuda"):
    """The fleet's shard engine (``buckets=64``) on the CPU: the ``cuda``
    backend runs the fused path's plain version there."""
    return VetEngine(backend, buckets=64, device="cpu")


def job_or_none(tick):
    try:
        return tick.job
    except ValueError:  # no stream has a complete window yet
        return None


def assert_rows_equal(got, ref, context=""):
    assert (got is None) == (ref is None), context
    if ref is None:
        return
    assert got.workers == ref.workers, context
    for name in ("vet", "ei", "oc", "pr", "t", "n"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=f"{context} {name}")


def retained(mux, sid):
    return (mux.collect(sid) if isinstance(mux, TransportVetMux)
            else mux.stream(sid).collect())


def lockstep(scenario, fleet, oracle):
    """Drive a scenario through a transport fleet and an oracle fleet in
    lockstep, comparing every tick exactly; returns the ticks."""
    for spec in scenario.specs:
        spec.register(fleet)
        spec.register(oracle)
    out = []
    for k, event in enumerate(scenario.events):
        for spec in event.joins:
            spec.register(fleet)
            spec.register(oracle)
        for sid, chunk in event.chunks.items():
            fleet.feed(sid, chunk)
            oracle.feed(sid, chunk)
        tick, ref = fleet.tick(), oracle.tick()
        ctx = f"{scenario.name} tick {k}"
        assert tick.serviced == ref.serviced, ctx
        assert tick.deferred == ref.deferred, ctx
        assert tick.urgent == ref.urgent, ctx
        assert tick.budgets == ref.budgets, ctx
        assert (tick.dispatches, tick.rows, tick.padded_rows) == \
               (ref.dispatches, ref.rows, ref.padded_rows), ctx
        assert tick.flags == ref.flags, ctx
        assert set(tick.results) == set(ref.results), ctx
        for sid, rr in ref.results.items():
            got = tick.results[sid]
            if rr is None or rr.workers == 0:
                assert got is None or got.workers == 0, f"{ctx} {sid}"
                continue
            # Transport ticks carry each stream's newest-window row only.
            assert got.workers == 1, f"{ctx} {sid}"
            for name in ("vet", "ei", "oc", "pr", "t", "n"):
                np.testing.assert_array_equal(
                    getattr(got, name)[-1:], getattr(rr, name)[-1:],
                    err_msg=f"{ctx} {sid} {name}")
        tj, rj = job_or_none(tick), job_or_none(ref)
        assert (tj is None) == (rj is None), ctx
        if rj is not None:
            assert tj == rj, ctx
        out.append(tick)
        for sid in event.leaves:
            fleet.deregister(sid)
            oracle.deregister(sid)
    fs, os_ = fleet.stats, oracle.stats
    assert (fs.ticks, fs.dispatches, fs.rows, fs.padded_rows, fs.deferred,
            fs.streams, fs.anomalies) == \
           (os_.ticks, os_.dispatches, os_.rows, os_.padded_rows,
            os_.deferred, os_.streams, os_.anomalies)
    for sid in list(fleet.ids()):
        assert_rows_equal(retained(fleet, sid), retained(oracle, sid),
                          context=f"{scenario.name} collect {sid}")
    return out


@pytest.fixture
def seeded_cpu(monkeypatch):
    """The parent's policy seeded to the CPU, no environment override: a
    worker that builds a ``device=None`` engine resolves the CPU only
    through the seed it is handed."""
    monkeypatch.delenv(runtime.ENV_VAR, raising=False)
    monkeypatch.setattr(runtime, "_PLATFORM", None)
    runtime.seed_platform_default("cpu")


# ---------------------------------------------------------- differential
@pytest.mark.parametrize("name", ["churn", "mixed_windows", "bursty"])
def test_inprocess_driver_equals_the_sharded_fleet(name):
    sc = build(name, n_workers=6, n_ticks=5, seed=11)
    with TransportVetMux(2, engine=cpu_engine(), driver="inprocess") as fleet:
        lockstep(sc, fleet, ShardedVetMux(2, engine=cpu_engine()))
        assert fleet.stats.retries == fleet.stats.respawns == 0


def test_budgeted_inprocess_driver_water_fills_like_the_sharded_fleet():
    sc = build("uniform", n_workers=6, n_ticks=4, window=16, seed=5)
    with TransportVetMux(2, engine=cpu_engine(), driver="inprocess",
                         budget=4) as fleet:
        oracle = ShardedVetMux(2, engine=cpu_engine(), budget=4)
        lockstep(sc, fleet, oracle)
        assert fleet.stats.deferred > 0  # the budget bit
        last, ref = fleet.flush(), oracle.flush()
        assert last.vet_job == ref.vet_job
        for sid in fleet.ids():
            assert_rows_equal(fleet.collect(sid), oracle.stream(sid).collect())


def test_process_driver_equals_the_inprocess_driver(seeded_cpu):
    """Two spawned workers whose engines carry ``device=None``: each
    resolves the CPU through the seeded parent policy (without the seed
    they would resolve ``cuda`` and raise at their first dispatch)."""
    sc = build("mixed_windows", n_workers=6, n_ticks=4, seed=3)
    oracle = TransportVetMux(2, engine=VetEngine("cuda", buckets=64),
                             driver="inprocess")
    with TransportVetMux(2, **PROCESS_KW) as fleet, oracle:
        assert fleet._specs[0].device is None
        lockstep(sc, fleet, oracle)
        assert fleet.stats.retries == fleet.stats.respawns == 0
        assert [a.checkpoints for a in fleet.accounts] == [4, 4]


# -------------------------------------------------------- crash recovery
def drive_steps(mux, *, steps=5, workers=6, seed=7, fault_at=None,
                fault_mode="mid"):
    """Deterministic feed/tick loop (the same draws for fleet and oracle);
    optionally arms a crash of shard 0's worker at tick ``fault_at + 1``."""
    rng = np.random.default_rng(seed)
    for w in range(workers):
        mux.register(f"w{w}", window=8, stride=4, capacity=64)
    ticks = []
    for step in range(steps):
        for w in range(workers):
            mux.feed(f"w{w}", rng.standard_normal(12) ** 2 + 1e-3)
        if fault_at is not None and step == fault_at:
            mux.inject_fault(0, at_tick=fault_at + 1, mode=fault_mode)
        ticks.append(mux.tick())
    return ticks


@pytest.mark.parametrize("mode", ["before", "mid"])
def test_kill_and_resume_counts_each_tick_once(mode):
    oracle = ShardedVetMux(2, engine=cpu_engine())
    o_ticks = drive_steps(oracle)
    with TransportVetMux(2, engine=cpu_engine(), **PROCESS_KW) as fleet:
        t_ticks = drive_steps(fleet, fault_at=2, fault_mode=mode)
        for ot, tt in zip(o_ticks, t_ticks):
            assert job_or_none(ot) == job_or_none(tt)
            assert (ot.rows, ot.dispatches) == (tt.rows, tt.dispatches)
        os_, ts = oracle.stats, fleet.stats
        assert (os_.dispatches, os_.rows, os_.padded_rows) == \
               (ts.dispatches, ts.rows, ts.padded_rows)
        assert ts.retries >= 1 and ts.respawns == 1
        acc = fleet.accounts
        assert acc[0].respawns == 1 and acc[0].retries >= 1
        assert acc[0].checkpoints >= 1 and acc[0].elapsed_s > 0
        assert acc[1].respawns == 0 and acc[1].retries == 0
        assert t_ticks[-1].accounts[0].respawns == 1
        for w in range(6):
            assert_rows_equal(fleet.collect(f"w{w}"),
                              oracle.stream(f"w{w}").collect(), f"w{w}")


def test_worker_without_a_card_raises_runtime_error_unretried(monkeypatch):
    """``REPRO_TORCH_DEVICE=cuda`` beats a parent seeded to the CPU; with no
    card the worker raises at its first dispatch, the ``RuntimeError``
    crosses the pipe by name and nothing retries or falls back."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    monkeypatch.setattr(runtime, "_PLATFORM", None)
    runtime.seed_platform_default("cpu")
    monkeypatch.setenv(runtime.ENV_VAR, "cuda")
    with TransportVetMux(1, engine=VetEngine("cuda", buckets=64),
                         **PROCESS_KW) as fleet:
        fleet.register("a", window=8, stride=4)
        fleet.feed("a", np.linspace(1e-3, 2e-3, 16))
        with pytest.raises(RuntimeError, match="no CUDA device") as err:
            fleet.tick()
        assert type(err.value) is RuntimeError  # not a TransportError
        assert fleet.accounts[0].retries == fleet.accounts[0].respawns == 0


# ------------------------------------------------- the reference transport
def fed_history(scenario):
    hist = {}
    for event in scenario.events:
        for sid, chunk in event.chunks.items():
            hist.setdefault(sid, []).append(np.asarray(chunk, np.float64))
    return {sid: np.concatenate(v) for sid, v in hist.items()}


@pytest.mark.parametrize("name,budget", [("mixed_windows", None),
                                         ("skewed_stragglers", 6),
                                         ("churn", None)])
def test_matches_the_reference_transport(name, budget):
    """Placement, budget splits and counters equal the reference's
    in-process transport (pure Python, nothing to round); retained rows
    hold to it under the near-tie contract (the port's torch backend
    against the reference's jax backend, which pads launches the same)."""
    sc = build(name, n_workers=6, n_ticks=5, seed=2)
    ref = ref_fleet.TransportVetMux(2, backend="jax", driver="inprocess",
                                    budget=budget)
    with TransportVetMux(2, engine=cpu_engine("torch"), driver="inprocess",
                         budget=budget) as got, ref:
        for spec in sc.specs:
            spec.register(got)
            spec.register(ref)
        for event in sc.events:
            for spec in event.joins:
                spec.register(got)
                spec.register(ref)
            for sid, chunk in event.chunks.items():
                got.feed(sid, chunk)
                ref.feed(sid, chunk)
            t, r = got.tick(), ref.tick()
            assert t.budgets == r.budgets
            assert (t.serviced, t.deferred, t.urgent) == \
                   (r.serviced, r.deferred, r.urgent)
            assert (t.dispatches, t.rows, t.padded_rows) == \
                   (r.dispatches, r.rows, r.padded_rows)
            for sid in event.leaves:
                got.deregister(sid)
                ref.deregister(sid)
        assert got.assignment == ref.assignment
        assert [(a.calls, a.retries, a.respawns, a.checkpoints)
                for a in got.accounts] == \
               [(a.calls, a.retries, a.respawns, a.checkpoints)
                for a in ref.accounts]
        gs, rs = got.stats, ref.stats
        assert tuple(gs[:6]) == tuple(rs[:6])
        hist = fed_history(sc)
        specs = {s.stream_id: s for s in sc.specs}
        specs.update((s.stream_id, s) for e in sc.events for s in e.joins)
        for sid in got.ids():
            spec = specs[sid]
            g, r = got.collect(sid), ref.collect(sid)
            assert g.workers == r.workers
            np.testing.assert_array_equal(g.n, r.n)

            def window(i, sid=sid, spec=spec):
                lo = i * spec.stride
                return hist[sid][lo:lo + spec.window]

            assert_contract(g, r, window, buckets=64, context=f"{name} {sid}")


# ------------------------------------------------------ host-only replies
def tensors_in(value, path="reply"):
    """Paths of every ``torch.Tensor`` inside a reply (containers walked)."""
    if isinstance(value, torch.Tensor):
        return [path]
    if isinstance(value, dict):
        return [p for k, v in value.items()
                for p in tensors_in(v, f"{path}[{k!r}]")]
    if isinstance(value, (list, tuple)):
        return [p for i, v in enumerate(value)
                for p in tensors_in(v, f"{path}[{i}]")]
    return []


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_every_reply_holds_host_values_only(backend):
    """No op replies with a tensor (a CUDA tensor sent over a pipe dies with
    its worker); every reply pickles."""
    sc = build("contention_onset", n_workers=3, n_ticks=12, window=16)
    w = ShardWorker(cpu_engine(backend))
    replies = [w.handle("trace", True)]
    for spec in sc.specs:
        replies.append(w.handle("register", {
            "sid": spec.stream_id, "window": spec.window,
            "stride": spec.stride, "capacity": spec.capacity,
            "history": None, "priority": 0.0, "tenant": spec.tenant}))
    for event in sc.events:
        for sid, chunk in event.chunks.items():
            replies.append(w.handle("feed", (sid, chunk)))
        replies.append(w.handle("demand", None))
        replies.append(w.handle("tick", None))
    assert any(r.flags for r in replies if isinstance(r, TickReply))
    assert all(r.spans for r in replies if isinstance(r, TickReply))
    replies += [w.handle("collect", "w0000"), w.handle("checkpoint", None),
                w.handle("stats", None), w.handle("deregister", "w0001")]
    assert isinstance(replies[-4], BatchVetResult)
    for r in replies:
        assert tensors_in(r) == []
        pickle.loads(pickle.dumps(r))


# ------------------------------------------------------------- seeding
class FakeConn:
    """A scripted pipe end: ``recv`` plays the commands, ``send`` records."""

    def __init__(self, commands):
        self.commands = list(commands)
        self.sent = []

    def recv(self):
        if not self.commands:
            raise EOFError
        return self.commands.pop(0)

    def send(self, msg):
        self.sent.append(msg)

    def close(self):
        pass


def run_worker_loop(hint):
    conn = FakeConn([("register", {"sid": "a", "window": 8, "stride": 4}),
                     ("feed", ("a", np.linspace(1e-3, 2e-3, 16))),
                     ("tick", None), ("shutdown", None)])
    spec = EngineSpec.from_engine(VetEngine("cuda", buckets=64))
    shard_worker_main(conn, spec, {}, 0, hint)
    return conn.sent


def test_worker_resolves_the_seeded_parent_device(monkeypatch):
    monkeypatch.delenv(runtime.ENV_VAR, raising=False)
    monkeypatch.setattr(runtime, "_PLATFORM", None)
    sent = run_worker_loop("cpu")
    assert runtime.platform_default_hint() == "cpu"
    assert runtime.default_device() == torch.device("cpu")
    assert [m[0] for m in sent] == ["ok"] * 4
    assert sent[2][1].rows == 3


def test_environment_beats_the_seed_in_the_worker(monkeypatch):
    monkeypatch.setattr(runtime, "_PLATFORM", None)
    monkeypatch.setenv(runtime.ENV_VAR, "cpu")
    sent = run_worker_loop("cuda")  # seeded cuda, the environment wins
    assert runtime.platform_default_hint() == "cuda"
    assert runtime.default_device() == torch.device("cpu")
    assert [m[0] for m in sent] == ["ok"] * 4


def test_engine_spec_carries_the_unresolved_device():
    assert EngineSpec.from_engine(VetEngine("cuda")).device is None
    spec = EngineSpec.from_engine(VetEngine("torch", buckets=32,
                                            device=torch.device("cpu")))
    assert spec == EngineSpec("torch", 3, 32, "log", "cpu", False, 128)
    built = spec.build()
    assert built._device_arg == "cpu" and built._device is None
    assert pickle.loads(pickle.dumps(spec)) == spec


def test_defaults_are_cuda_and_spawn():
    params = inspect.signature(TransportVetMux).parameters
    assert params["backend"].default == "cuda"
    assert params["mp_context"].default == "spawn"
    with TransportVetMux(2, driver="inprocess") as fleet:
        assert fleet._specs == [EngineSpec("cuda", 3, 64, "log", None, True,
                                           128)] * 2


def test_no_kernel_build_without_a_card(monkeypatch):
    """The driver builds the kernel library before spawning only when a
    worker will launch the kernels; here there is no card, so nothing is
    built (and nvcc, absent here, is never asked for)."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    from repro_torch.fleet.transport import driver

    def boom():
        raise AssertionError("built without a card")

    monkeypatch.setattr(runtime, "build_library", boom)
    monkeypatch.delenv(runtime.ENV_VAR, raising=False)
    monkeypatch.setattr(runtime, "_PLATFORM", None)
    driver._build_kernels_for([EngineSpec.from_engine(VetEngine("cuda"))])


# -------------------------------------------------------- retry/backoff
class FlakyChannel:
    """Fault-injecting channel double: the next ``fail`` receives raise a
    transport failure, later ones return ``reply``.  Records everything."""

    def __init__(self, fail=0, reply=("ok", 42)):
        self.fail = fail
        self.reply = reply
        self.alive = False
        self.spawns = 0
        self.sent = []

    def spawn(self):
        self.spawns += 1
        self.alive = True

    def send(self, msg):
        if not self.alive:
            raise _TransportFailure("send on a dead channel")
        self.sent.append(msg)

    def recv(self, timeout):
        if self.fail > 0:
            self.fail -= 1
            raise _TransportFailure("injected")
        return self.reply

    def kill(self):
        self.alive = False

    def close(self):
        self.alive = False


def handle_with(channel, **kw):
    sleeps = []
    kw.setdefault("max_retries", 3)
    kw.setdefault("backoff_base", 0.05)
    kw.setdefault("backoff_factor", 2.0)
    h = ShardHandle(0, channel, sleep=sleeps.append, **kw)
    channel.spawn()  # the driver spawns eagerly; initial spawn != respawn
    return h, sleeps


class TestShardHandle:
    def test_transient_failures_retry_with_exponential_backoff(self):
        ch = FlakyChannel(fail=3)
        h, sleeps = handle_with(ch)
        assert h.call("stats", None) == 42
        assert sleeps == [0.05, 0.1, 0.2]  # base * factor**attempt
        assert h.retries == 3 and h.respawns == 3
        assert h.calls == 1

    def test_retry_budget_exhaustion_is_a_transport_error(self):
        h, sleeps = handle_with(FlakyChannel(fail=99), max_retries=2)
        with pytest.raises(TransportError, match="after 2 retries"):
            h.call("tick", None)
        assert sleeps == [0.05, 0.1]
        assert h.retries == 2 and h.calls == 0

    def test_logical_errors_reraise_by_name_and_never_retry(self):
        h, sleeps = handle_with(FlakyChannel(
            reply=("err", "KeyError", "'nope'")))
        with pytest.raises(KeyError, match="nope"):
            h.call("feed", ("nope", None))
        assert sleeps == [] and h.retries == 0 and h.calls == 0

    def test_runtime_errors_reraise_as_runtime_error(self):
        h, sleeps = handle_with(FlakyChannel(
            reply=("err", "RuntimeError", "no CUDA device is available")))
        with pytest.raises(RuntimeError, match="no CUDA") as err:
            h.call("tick", None)
        assert type(err.value) is RuntimeError
        assert sleeps == [] and h.retries == 0

    def test_unknown_error_types_arrive_as_transport_error_unretried(self):
        h, _ = handle_with(FlakyChannel(reply=("err", "Exotic", "boom")))
        with pytest.raises(TransportError, match="boom"):
            h.call("tick", None)
        assert h.retries == 0

    def test_revive_replays_checkpoint_then_journal_in_order(self):
        ch = FlakyChannel()
        h, _ = handle_with(ch)
        h.checkpoint_blob = {"mock": "checkpoint"}
        h.journal.extend([("register", {"sid": "a"}), ("feed", ("a", 1))])
        h.trace_enabled = True
        h._revive()
        assert ch.sent == [("restore", {"mock": "checkpoint"}),
                           ("register", {"sid": "a"}), ("feed", ("a", 1)),
                           ("trace", True)]
        assert h.respawns == 1

    def test_a_failed_replay_is_a_transport_error(self):
        h, _ = handle_with(FlakyChannel(reply=("err", "ValueError", "x")))
        h.journal.append(("feed", ("a", 1)))
        with pytest.raises(TransportError, match="resume replay"):
            h._revive()

    def test_journaled_commands_accumulate_until_checkpoint(self):
        h, _ = handle_with(FlakyChannel(reply=("ok", None)))
        h.call("register", {"sid": "a"}, journal=True)
        h.call("feed", ("a", 1), journal=True)
        h.call("stats", None)  # read-only: not journaled
        assert h.journal == [("register", {"sid": "a"}), ("feed", ("a", 1))]

    def test_finish_tick_falls_back_to_the_reliable_path(self):
        h, sleeps = handle_with(FlakyChannel(fail=1))
        h.tick_async(None)
        assert h.finish_tick() == 42
        assert h.retries == 1 and sleeps == [0.05]

    def test_account_mirrors_the_counters(self):
        h, _ = handle_with(FlakyChannel(fail=1))
        h.call("stats", None)
        acc = h.account
        assert (acc.calls, acc.retries, acc.respawns, acc.checkpoints) == \
               (1, 1, 1, 0)
        assert acc.elapsed_s >= 0.0


# ------------------------------------------------------------- lifecycle
def test_tracer_adopts_worker_spans_on_their_lanes():
    """Worker spans ride back on each reply and land on lane shard + 1:
    one fused ``engine.dispatch`` per shard per tick on the cuda backend."""
    tracer = Tracer()
    with TransportVetMux(2, engine=cpu_engine(), driver="inprocess",
                         tracer=tracer) as fleet:
        for w in range(4):
            fleet.register(w, window=8 * (w % 2 + 1), stride=4)
        for _ in range(3):
            for w in range(4):
                fleet.feed(w, np.linspace(1e-3, 2e-3, 16) * (w + 1))
            fleet.tick()
    lanes = {}
    for r in tracer.records:
        attrs = dict(r.attrs)
        if r.name == "engine.dispatch":
            assert (attrs["backend"], attrs["kind"]) == ("cuda", "fused")
            lanes[r.pid] = lanes.get(r.pid, 0) + 1
    assert lanes == {1: 3, 2: 3}
    # one worker.tick per shard per tick; the wrappers run plain on the
    # CPU, so no kernel launch is counted
    ticks = [(r.pid, dict(r.attrs)) for r in tracer.records
             if r.name == "worker.tick"]
    assert sorted(ticks, key=lambda t: t[0]) == \
        [(pid, {"windowvet_launches": 0, "changepoint_launches": 0})
         for pid in (1, 1, 1, 2, 2, 2)]
    assert tracer.process_names[1] == "shard0"
    assert any(r.name == "transport.send" and r.pid == 0
               for r in tracer.records)


def test_worker_tick_span_counts_the_launches_of_its_tick(monkeypatch):
    """A traced worker's ``worker.tick`` span carries the change of the
    window-vet and change-point wrappers' ``LAUNCHES`` over that tick alone
    (the kernels launch in the worker, so its counters are the count)."""
    from repro_torch.kernels.changepoint import ops as cp
    from repro_torch.kernels.windowvet import ops as wv
    monkeypatch.setattr(wv, "LAUNCHES", 7)
    monkeypatch.setattr(cp, "LAUNCHES", 3)
    worker = ShardWorker(cpu_engine())
    worker.handle("trace", True)
    worker.handle("register", {"sid": 0, "window": 8, "stride": 4})
    tick = worker.mux.tick

    def launching_tick():  # one fused launch, and a scan on odd ticks
        wv.LAUNCHES += 1
        cp.LAUNCHES += wv.LAUNCHES % 2
        return tick()

    monkeypatch.setattr(worker.mux, "tick", launching_tick)
    seen = []
    for _ in range(3):
        worker.handle("feed", (0, np.linspace(1e-3, 2e-3, 8)))
        seen += [dict(r.attrs) for r in worker.handle("tick", None).spans
                 if r.name == "worker.tick"]
    assert seen == [{"windowvet_launches": 1, "changepoint_launches": c}
                    for c in (0, 1, 0)]


def test_surface_validation():
    with pytest.raises(ValueError, match="driver"):
        TransportVetMux(2, backend="numpy", driver="carrier-pigeon")
    with pytest.raises(ValueError, match="checkpoint_every"):
        TransportVetMux(2, backend="numpy", driver="inprocess",
                        checkpoint_every=0)
    with pytest.raises(ValueError, match="budget"):
        TransportVetMux(2, backend="numpy", driver="inprocess", budget=0)
    with pytest.raises(ValueError, match="not both"):
        TransportVetMux(engines=[EngineSpec.from_engine(cpu_engine())],
                        engine=cpu_engine(), driver="inprocess")
    with TransportVetMux(2, backend="numpy", driver="inprocess") as fleet:
        with pytest.raises(ValueError, match="process boundary"):
            fleet.register("a", stream=VetStream(cpu_engine(), window=8))
        with pytest.raises(ValueError, match="window"):
            fleet.register("a")
        fleet.register("a", window=8)
        with pytest.raises(ValueError, match="already registered"):
            fleet.register("a", window=8)
        with pytest.raises(TypeError, match="collect"):
            fleet.stream("a")
        with pytest.raises(KeyError, match="not registered"):
            fleet.feed("ghost", np.ones(4))
        with pytest.raises(ValueError, match="process"):
            fleet.inject_fault(0, at_tick=1)
        assert fleet.stats.retries == 0


def test_placement_mirrors_the_sharded_fleet():
    smux = ShardedVetMux(3, backend="numpy")
    with TransportVetMux(3, backend="numpy", driver="inprocess") as fleet:
        for i, w in enumerate((8, 16, 8, 32, 16, 8)):
            smux.register(i, window=w, stride=w // 2, capacity=4 * w)
            assert fleet.register(i, window=w, stride=w // 2,
                                  capacity=4 * w) == smux.shard_of(i)
        assert fleet.assignment == smux.assignment
        assert list(fleet.ids()) == list(smux.ids())


def test_deregister_pulls_the_stream_back_across_the_boundary():
    with TransportVetMux(2, engine=cpu_engine(), driver="inprocess") as fleet:
        fleet.register("a", window=8, stride=4, capacity=64)
        times = np.linspace(1e-3, 2e-3, 20)
        fleet.feed("a", times)
        fleet.tick()
        stream = fleet.deregister("a")
        assert isinstance(stream, VetStream) and "a" not in fleet
        ref = cpu_engine().vet_sliding(times, window=8, stride=4)
        np.testing.assert_array_equal(stream.collect().vet, ref.vet)


def test_flush_boundary_is_pinned():
    def backlog():
        fleet = TransportVetMux(2, backend="numpy", driver="inprocess",
                                budget=2)
        fleet.register("a", window=8, stride=4, capacity=256)
        fleet.feed("a", np.linspace(1e-3, 2e-3, 40))  # 9 windows
        return fleet
    with backlog() as fleet:
        assert not fleet.flush(max_ticks=5).deferred
    with backlog() as fleet:
        with pytest.raises(RuntimeError, match="did not converge"):
            fleet.flush(max_ticks=4)


def test_wire_constants_match_the_reference():
    from repro.fleet.transport import proto as ref_proto
    from repro_torch.fleet.transport import proto
    assert FAULT_EXIT == ref_proto.FAULT_EXIT == 17
    assert proto.LOGICAL_EXCEPTIONS == ref_proto.LOGICAL_EXCEPTIONS
    for name in ("TickReply", "ShardAccount", "WorkerFault"):
        assert getattr(proto, name)._fields == \
               getattr(ref_proto, name)._fields
    assert EngineSpec._fields == ("backend", "omega", "buckets", "cut_space",
                                  "device", "fused", "cache_size")
    assert WorkerFault(3) == (3, "before")
