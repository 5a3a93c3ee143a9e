"""``repro_torch.sched.VetController`` and ``repro_torch.profiling``'s
contention harness against the reference (``repro.sched.straggler``,
``repro.profiling.contention``).

The controller is host logic (warm-up grouping, KS confirmation against the
pooled profile, the W-rule with its hysteresis and reason strings) over one
fleet mux.  It is held on a reduced ``skewed_stragglers`` fleet (16
workers, a quarter of them stragglers):

- **bit for bit, on the same rows**: with the port's ``numpy`` engine
  computing its rows with the reference's ``vet_task`` (``same_rows``),
  every decision equals the reference's, field by field, worker vets
  included: with ``shards=1`` and ``2``, warm-up workers, an
  auto-registered worker and ``apply()``;
- **on the port's own rows**: the ``numpy`` engine against the reference's
  and ``torch`` against ``jax``, the same targets, stragglers and reasons,
  vets to the ladder's 1e-5 (``torch_port_contract.RTOL``).

``run_contended_job`` is held to its arithmetic with a deterministic record
``work`` on a per-thread fake clock: task count, unit grouping, the hook
outside the timed region and error propagation.  No wall-clock assertion
(the reference's own wall-clock test fails under load).
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import repro.core.vet as ref_vet
import repro_torch.engine.engine as port_engine_module
from repro.engine import VetEngine as RefEngine
from repro.profiling import run_contended_job as ref_contended
from repro.sched import VetController as RefController
from repro_torch.engine import VetEngine, default_engine
from repro_torch.fleet import ShardedVetMux, VetMux
from repro_torch.fleet.scenarios import skewed_stragglers
from repro_torch.kernels import runtime
from repro_torch.profiling import make_record_work, run_contended_job
from repro_torch.sched import SchedulerDecision, VetController

from torch_port_contract import RTOL

WINDOW = 64
N_TICKS = 8


@pytest.fixture
def same_rows(monkeypatch):
    """The port's numpy engine computes its rows with the reference's
    ``vet_task``: both controllers then consume bit-identical rows."""
    monkeypatch.setattr(port_engine_module, "vet_task", ref_vet.vet_task)


def feed_plan(variant):
    """Per tick, the ``(worker, chunk)`` feeds of one variant."""
    sc = skewed_stragglers(n_workers=16, window=WINDOW, n_ticks=N_TICKS,
                           straggler_frac=0.25, seed=0)
    rng = np.random.default_rng(9)
    plan = []
    for k, ev in enumerate(sc.events):
        feeds = [(int(sid[1:]), chunk) for sid, chunk in ev.chunks.items()]
        if variant == "skewed":
            # A slow worker that never fills a window (warm-up every tick,
            # its buffer length changing) and one that joins at tick 3.
            feeds.append((16, 1e-3 * (1 + rng.random(5 + 3 * k))))
            if k >= 3:
                feeds.append((99, 1e-3 * (1 + rng.random(20))))
        plan.append(feeds)
    return plan


VARIANTS = {
    # name: controller arguments, whether decisions are applied
    "skewed": (dict(n_workers=16), False),
    # 6 registered workers, 10 auto-registered on their first feed; the
    # applied shrinks bring the worker count under vet_job (the W-rule).
    "apply": (dict(n_workers=6, min_workers=2), True),
}


def drive(ctl, variant):
    apply = VARIANTS[variant][1]
    out = [ctl.decide()]  # before any feed: insufficient data
    for feeds in feed_plan(variant):
        for wid, chunk in feeds:
            ctl.feed(wid, chunk)
        d = ctl.decide()
        out.append(d)
        if apply:
            ctl.apply(d)
    return out


def controllers(variant, backend, ref_backend, shards=1):
    kw = dict(VARIANTS[variant][0], window_records=WINDOW, shards=shards)
    dev = {} if backend == "numpy" else {"device": "cpu"}
    return (VetController(engine=VetEngine(backend, buckets=64, **dev), **kw),
            RefController(engine=RefEngine(ref_backend, buckets=64), **kw))


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decisions_are_bitwise_on_the_same_rows(same_rows, variant, shards):
    port, ref = controllers(variant, "numpy", "numpy", shards)
    got, want = drive(port, variant), drive(ref, variant)
    assert all(isinstance(d, SchedulerDecision) for d in got)
    assert [dataclasses.asdict(d) for d in got] == \
        [dataclasses.asdict(d) for d in want]
    assert port.n_workers == ref.n_workers
    assert isinstance(port.mux, ShardedVetMux if shards > 1 else VetMux)
    assert got[0].reason == "insufficient data"
    if variant == "skewed":
        assert any(d.reason.endswith(": shrink") for d in got)
        assert any(d.stragglers for d in got)
        assert 16 in got[-1].worker_vets and 99 in got[-1].worker_vets
    else:
        assert any("(paper W-rule)" in d.reason for d in got)
        assert got[-1].target_workers < 6


@pytest.mark.parametrize("backend,ref_backend", [("numpy", "numpy"),
                                                 ("torch", "jax")])
def test_decisions_on_the_ports_own_rows(backend, ref_backend):
    port, ref = controllers("skewed", backend, ref_backend)
    for a, b in zip(drive(port, "skewed"), drive(ref, "skewed")):
        assert (a.target_workers, a.stragglers, a.reason) == \
            (b.target_workers, b.stragglers, b.reason)
        assert a.vet_job == pytest.approx(b.vet_job, rel=RTOL)
        assert a.worker_vets.keys() == b.worker_vets.keys()
        for k, v in a.worker_vets.items():
            assert v == pytest.approx(b.worker_vets[k], rel=RTOL)


def test_healthy_grows_and_steady_holds():
    rng = np.random.default_rng(1)
    ctl = VetController(2, max_workers=4,
                        engine=VetEngine("torch", buckets=64, device="cpu"))
    for w in range(2):
        ctl.feed(w, 1.0 + 0.01 * rng.random(400))
    d = ctl.decide()
    assert d.vet_job < 1.1 and d.target_workers == 3
    assert d.reason == f"vet_job {d.vet_job:.2f} < 1.1: headroom, grow"
    ctl.apply(d)
    assert ctl.n_workers == 3
    ctl = VetController(2, max_workers=2,
                        engine=VetEngine("torch", buckets=64, device="cpu"))
    for w in range(2):
        ctl.feed(w, 1.0 + 0.01 * rng.random(400))
    assert ctl.decide().reason == "steady"  # already at max_workers


def test_sharded_equals_one_mux_on_the_torch_engine():
    a, _ = controllers("skewed", "torch", "jax", shards=1)
    b, _ = controllers("skewed", "torch", "jax", shards=2)
    for x, y in zip(drive(a, "skewed"), drive(b, "skewed")):
        assert dataclasses.asdict(x) == dataclasses.asdict(y)


def test_cuda_backend_dispatches_once_per_decide():
    """On the fused ``cuda`` backend (plain versions on the CPU) a decide()
    is one fused dispatch once windows complete, and warm-up workers one
    ``vet_many`` dispatch per distinct buffer length."""
    eng = VetEngine("cuda", buckets=64, device="cpu")
    ctl = VetController(16, window_records=WINDOW, engine=eng)
    assert ctl.mux.monitor.method == "cuda"
    per_tick = []
    for feeds in feed_plan("apply"):  # the 16 scenario workers only
        for wid, chunk in feeds:
            ctl.feed(wid, chunk)
        before = eng.dispatches
        ctl.decide()
        per_tick.append(eng.dispatches - before)
    # Tick 1 holds half a window (warm-up, one length); then one new window
    # per worker per tick, all in one fused dispatch.
    assert per_tick == [1] * N_TICKS


def test_ready_and_auto_registration():
    ctl = VetController(1, engine=VetEngine("numpy", buckets=64))
    assert not ctl.ready()
    ctl.feed(0, np.linspace(1e-3, 2e-3, 32))
    assert ctl.ready()
    ctl.feed(7, [1e-3])
    assert len(ctl.mux) == 2 and not ctl.ready()


def test_default_engine_is_the_shared_cuda_engine_resolved_lazily(
        monkeypatch):
    monkeypatch.delenv(runtime.ENV_VAR, raising=False)
    monkeypatch.setattr(runtime, "_PLATFORM", None)
    ctl = VetController(4)
    assert ctl.engine is default_engine("cuda")
    assert ctl.mux.monitor.method == "cuda"
    # The shared engine keeps the device it resolved first; resolve anew
    # under this test's policy.
    monkeypatch.setattr(ctl.engine, "_device", None)
    for w in range(4):
        ctl.feed(w, np.linspace(1e-3, 2e-3, 40))
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctl.decide()


# ------------------------------------------------------------ contention
class FakeClock:
    """A per-thread clock: ``work`` advances the calling thread's time by
    0.5 s and ``hook`` by 64 s, so every record's time is exactly 0.5 s
    when the hook runs outside the timed region."""

    def __init__(self):
        self.local = threading.local()
        self.calls = []
        self.lock = threading.Lock()

    def now(self):
        return getattr(self.local, "t", 0.0)

    def work(self):
        self.local.t = self.now() + 0.5
        return 0.0

    def hook(self, task_id, record_id):
        self.local.t = self.now() + 64.0
        with self.lock:
            self.calls.append((task_id, record_id))


@pytest.mark.parametrize("harness", [run_contended_job, ref_contended])
@pytest.mark.parametrize("n_tasks,records,unit", [(1, 23, 5), (3, 40, 4),
                                                  (4, 9, 10)])
def test_contended_job_arithmetic(monkeypatch, harness, n_tasks, records,
                                  unit):
    clock = FakeClock()
    monkeypatch.setattr(time, "perf_counter", clock.now)
    out = harness(n_tasks, records, work=clock.work, unit=unit,
                  per_record_hook=clock.hook)
    assert len(out) == n_tasks
    for times in out:
        assert times.dtype == np.float64
        np.testing.assert_array_equal(times,
                                      np.full(records // unit, 0.5 * unit))
    assert sorted(clock.calls) == [(t, r) for t in range(n_tasks)
                                   for r in range(records)]


class Boom(Exception):
    pass


@pytest.mark.parametrize("fail_at", ["warm-up", "record"])
def test_contended_job_raises_a_tasks_error(fail_at):
    """The first error a task raises surfaces; a task failing before the
    barrier does not leave the others waiting there."""
    calls = {"n": 0}
    lock = threading.Lock()

    def work():
        with lock:
            calls["n"] += 1
            n = calls["n"]
        if (fail_at == "warm-up" and n == 1) or (fail_at == "record"
                                                 and n == 10):
            raise Boom(fail_at)
        return 0.0

    result = {}

    def run():
        try:
            run_contended_job(3, 20, work=work)
        except Boom as e:
            result["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "run_contended_job hung"
    assert str(result.get("error")) == fail_at


def test_record_work_is_a_deterministic_host_matmul():
    a, b = make_record_work(size=16, reps=2), make_record_work(size=16,
                                                               reps=2)
    assert isinstance(a(), float) and a() == b()
