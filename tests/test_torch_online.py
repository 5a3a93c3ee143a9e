"""``repro_torch.core.online.OnlineVet`` against ``repro.core.online``.

The estimator is host logic (the EMA fold, the history clamp, the rewind
re-fold) over a ``VetStream``, so it is held in two ways:

- **bit for bit, on the same rows.**  With the port's ``numpy`` engine
  computing its rows with the reference's ``vet_task`` (the ``same_rows``
  fixture), every snapshot equals the reference's: with and without
  ``history``, record at a time against chunked, after ``stream.amend``,
  and through ``sliding()``.
- **on the port's own rows.**  The port's ``numpy`` engine takes its f32
  sums in PyTorch's order, so its rows are within ~1e-7 of the reference's
  ``numpy`` engine and the snapshots within the ladder's 1e-5
  (``torch_port_contract.RTOL``); the ``torch`` engine against ``jax`` the
  same, on the bucketed gather path of ``OnlineVet``'s default
  ``window=512``.
"""

import numpy as np
import pytest
import torch

import repro.core.vet as ref_vet
import repro_torch.engine.engine as port_engine_module
from repro.core import OnlineVet as RefOnlineVet
from repro.engine import VetEngine as RefEngine
from repro_torch.core import OnlineVet, OnlineVetSnapshot
from repro_torch.engine import VetEngine, default_engine
from repro_torch.kernels import runtime
from repro_torch.kernels.changepoint import ops as cp

from torch_port_contract import RTOL


def make_times(n=640, seed=0):
    """The reference suite's online profile (tests/test_vet_stream.py)."""
    rng = np.random.default_rng(seed)
    t = 1e-3 * (1 + 0.05 * rng.random(n))
    t[::7] += rng.pareto(1.3, t[::7].shape) * 5e-3
    return t


@pytest.fixture
def same_rows(monkeypatch):
    """The port's numpy engine computes its rows with the reference's
    ``vet_task``: both estimators then consume bit-identical rows."""
    monkeypatch.setattr(port_engine_module, "vet_task", ref_vet.vet_task)


def pair(window, history=None, **kw):
    return (OnlineVet(window=window, history=history,
                      engine=VetEngine("numpy", buckets=64), **kw),
            RefOnlineVet(window=window, history=history,
                         engine=RefEngine("numpy", buckets=64), **kw))


def feed_all(ov, times, chunk):
    out = []
    for lo in range(0, times.size, chunk):
        out.extend(ov.feed(times[lo:lo + chunk]))
    return out


@pytest.mark.parametrize("history", [None, 1, 8])
@pytest.mark.parametrize("chunk", [1, 96, 640])
def test_snapshots_are_bitwise_on_the_same_rows(same_rows, history, chunk):
    times = make_times(640, seed=6)
    port, ref = pair(64, history)
    got, want = feed_all(port, times, chunk), feed_all(ref, times, chunk)
    assert len(got) == (640 - 64) // 32 + 1
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    assert all(isinstance(s, OnlineVetSnapshot) for s in got)
    assert port.snapshot == got[-1]
    assert port.stream.first_retained == ref.stream.first_retained
    assert port.stream.stats == tuple(ref.stream.stats)


def test_chunked_equals_record_at_a_time(same_rows):
    times = make_times(seed=1)
    a = feed_all(pair(64)[0], times, 1)
    b = feed_all(pair(64)[0], times, 160)
    assert a == b and len(a) > 0


def test_amend_refolds_as_the_reference(same_rows):
    times = make_times(256, seed=5)
    port, ref = pair(128)
    stale = port.feed(times)
    assert [tuple(s) for s in stale] == [tuple(s) for s in ref.feed(times)]
    port.stream.amend(200, [times[200] + 5.0])
    ref.stream.amend(200, [times[200] + 5.0])
    got, want = port.feed([]), ref.feed([])  # only the re-vetted rows emit
    assert got and [tuple(s) for s in got] == [tuple(s) for s in want]
    assert got[-1].vet != stale[-1].vet


@pytest.mark.parametrize("window,stride", [(32, 16), (64, 1), (17, 5)])
def test_sliding_is_bitwise_on_the_same_rows(same_rows, window, stride):
    times = make_times(300, seed=2)
    port, ref = pair(128)
    port.feed(times), ref.feed(times)
    got = port.sliding(window=window, stride=stride)
    want = ref.sliding(window=window, stride=stride)
    for name in ("vet", "ei", "oc", "pr", "t", "n"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))


def test_sliding_needs_a_full_window():
    port, _ = pair(64)
    port.feed(make_times(40))
    with pytest.raises(ValueError, match="exceeds the stream length"):
        port.sliding(window=64)


def test_window_below_64_and_2d_feed_rejected():
    with pytest.raises(ValueError, match="window must be >= 64"):
        OnlineVet(window=63)
    with pytest.raises(ValueError, match="1-D"):
        pair(64)[0].feed(np.ones((4, 4)))


def assert_snapshots_close(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.n_window == b.n_window
        for name in ("vet", "ei_rate", "pr_rate", "smoothed_vet"):
            assert getattr(a, name) == pytest.approx(getattr(b, name),
                                                     rel=RTOL), name


@pytest.mark.parametrize("history", [None, 8])
def test_numpy_engine_against_the_reference(history):
    times = make_times(2048, seed=3)
    port, ref = pair(128, history)
    assert_snapshots_close(feed_all(port, times, 100),
                           feed_all(ref, times, 100))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_batched_engines_against_jax_on_the_gather_path(backend):
    """``window=512`` at ``buckets=64``: every window is bucketed, so the
    engine takes its gather path (the ``cuda`` backend's change-point
    wrapper runs its plain version on the CPU, one call per dispatch)."""
    times = make_times(4096, seed=4)
    eng = VetEngine(backend, buckets=64, device="cpu")
    port = OnlineVet(window=512, engine=eng)
    ref = RefOnlineVet(window=512, engine=RefEngine("jax", buckets=64))
    before = cp.LAUNCHES
    got = feed_all(port, times, 1024)
    assert_snapshots_close(got, feed_all(ref, times, 1024))
    assert len(got) == (4096 - 512) // 256 + 1
    # The CPU plain path is no launch; the engine dispatches once per tick.
    assert cp.LAUNCHES == before and eng.dispatches > 0


def test_default_engine_is_the_shared_cuda_engine_resolved_lazily(
        monkeypatch):
    """``OnlineVet()`` builds on ``default_engine("cuda", buckets=64)``
    without touching CUDA; with no card its first dispatch raises."""
    monkeypatch.delenv(runtime.ENV_VAR, raising=False)
    monkeypatch.setattr(runtime, "_PLATFORM", None)
    ov = OnlineVet()
    assert ov.engine is default_engine("cuda", buckets=64)
    # The shared engine keeps the device it resolved first; resolve anew
    # under this test's policy.
    monkeypatch.setattr(ov.engine, "_device", None)
    assert ov.feed(np.ones(100)) == []  # no window yet: no dispatch
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ov.feed(make_times(512))
