"""``repro_torch.engine.VetEngine`` against ``repro.engine.VetEngine``.

Backend pairs: port ``numpy``/``torch``/``cuda`` against reference
``numpy``/``jax``/``pallas``, the batched port backends on ``device="cpu"``
(the ``cuda`` backend's kernel wrappers then run their plain versions).
Values are held to the near-tie contract of ``torch_port_contract``; the
dispatch, byte and cache counters must be equal, since the fleet layers and
their tests read them.
"""

import numpy as np
import pytest

from repro.engine import VetEngine as RefEngine
from repro_torch.engine import BACKENDS, VetEngine, default_engine
from repro_torch.kernels import runtime

from torch_port_contract import assert_contract, noiseless_matrix, sim_matrix

PAIRS = list(zip(BACKENDS, ("numpy", "jax", "pallas")))


def engines(backend, ref_backend, **kw):
    dev = {} if backend == "numpy" else {"device": "cpu"}
    return VetEngine(backend, **dev, **kw), RefEngine(ref_backend, **kw)


def counters(e):
    ci = e.cache_info()
    return (e.dispatches, e.dispatch_bytes, ci.hits, ci.misses, ci.size)


def stream(n, seed=0):
    return np.concatenate([sim_matrix(1, n // 2, seed)[0],
                           sim_matrix(1, n - n // 2, seed + 50)[0]])


@pytest.mark.parametrize("backend,ref_backend", PAIRS)
class TestBackendsAgainstReference:
    def test_vet_batch(self, backend, ref_backend):
        m = sim_matrix(16, 320, seed=1)
        port, ref = engines(backend, ref_backend, buckets=64)
        got, want = port.vet_batch(m), ref.vet_batch(m)
        assert_contract(got, want, lambda i: m[i], 64, "log", "vet_batch")
        np.testing.assert_array_equal(got.n, want.n)
        port.vet_batch(m), ref.vet_batch(m)  # cache hits
        assert counters(port) == counters(ref)
        assert not got.vet.flags.writeable

    def test_vet_many(self, backend, ref_backend):
        profiles = [sim_matrix(1, n, seed=n)[0] for n in (40, 300, 40, 96)]
        port, ref = engines(backend, ref_backend, buckets=64)
        got, want = port.vet_many(profiles), ref.vet_many(profiles)
        assert_contract(got, want, lambda i: profiles[i], 64, "log",
                        "vet_many")
        np.testing.assert_array_equal(got.n, [40, 300, 40, 96])
        assert counters(port) == counters(ref)
        assert port.vet_job(profiles) == pytest.approx(got.vet_job, rel=0)

    @pytest.mark.parametrize("window,stride", [(64, 16), (200, 100),
                                               (256, 128)])
    def test_vet_sliding(self, backend, ref_backend, window, stride):
        """Windows < 4*buckets take the fused path on cuda/pallas; 256 is
        bucketed and keeps the gather path."""
        s = stream(640, seed=window)
        port, ref = engines(backend, ref_backend, buckets=64)
        got = port.vet_sliding(s, window, stride)
        want = ref.vet_sliding(s, window, stride)
        assert_contract(got, want,
                        lambda i: s[i * stride:i * stride + window], 64, "log",
                        f"vet_sliding {window}/{stride}")
        assert port.fused_supported(window) == ref.fused_supported(window)
        assert counters(port) == counters(ref)

    def test_vet_windows(self, backend, ref_backend):
        s = stream(500, seed=3)
        bounds = [(0, 64), (10, 200), (100, 356), (400, 406), (0, 500),
                  (300, 302)]
        port, ref = engines(backend, ref_backend, buckets=64)
        got, want = port.vet_windows(s, bounds), ref.vet_windows(s, bounds)
        assert_contract(got, want, lambda i: s[slice(*bounds[i])], 64, "log",
                        "vet_windows")
        np.testing.assert_array_equal(got.n, want.n)
        assert counters(port) == counters(ref)

    def test_paper_literal_estimator(self, backend, ref_backend):
        m = sim_matrix(6, 200, seed=10)
        kw = dict(buckets=None, cut_space="raw")
        port, ref = engines(backend, ref_backend, **kw)
        assert_contract(port.vet_batch(m), ref.vet_batch(m), lambda i: m[i],
                        None, "raw", "paper literal")

    def test_noiseless_cut_is_identical(self, backend, ref_backend):
        m = noiseless_matrix()
        port, ref = engines(backend, ref_backend, buckets=None)
        np.testing.assert_array_equal(port.vet_batch(m).t, ref.vet_batch(m).t)
        np.testing.assert_array_equal(port.vet_sliding(m[0], 200, 28).t,
                                      ref.vet_sliding(m[0], 200, 28).t)

    def test_pad_rows_pow2(self, backend, ref_backend):
        port, ref = engines(backend, ref_backend)
        for rows in (1, 5, 8, 9):
            a, pa = port.pad_rows_pow2(np.ones((rows, 4)))
            b, pb = ref.pad_rows_pow2(np.ones((rows, 4)))
            assert a.shape == b.shape and pa == pb


class TestEngineContract:
    def test_cuda_without_a_card_raises_at_first_dispatch(self, monkeypatch):
        """No device argument resolves to cuda; constructing touches nothing,
        the first dispatch raises (this machine has no card)."""
        monkeypatch.delenv(runtime.ENV_VAR, raising=False)
        eng = VetEngine()
        assert eng.backend == "cuda" and eng._device is None
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eng.vet_batch(sim_matrix(2, 64))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eng.vet_sliding(sim_matrix(1, 128)[0], 64, 32)

    def test_environment_selects_the_cpu(self, monkeypatch):
        monkeypatch.setenv(runtime.ENV_VAR, "cpu")
        eng = VetEngine("cuda", buckets=64)
        assert eng.vet_batch(sim_matrix(2, 64)).workers == 2
        assert str(eng.device) == "cpu"

    def test_device_policy(self, monkeypatch):
        monkeypatch.delenv(runtime.ENV_VAR, raising=False)
        assert str(runtime.resolve_device(None)) == "cuda"
        assert str(runtime.resolve_device("cpu")) == "cpu"
        monkeypatch.setenv(runtime.ENV_VAR, "cpu")
        assert str(runtime.resolve_device(None)) == "cpu"
        assert str(runtime.resolve_device("cuda:1")) == "cuda:1"
        assert VetEngine("numpy").device.type == "cpu"

    def test_seeded_default_for_workers(self, monkeypatch):
        """A driver seeds its workers' default without touching CUDA; the
        environment still wins over the seed."""
        monkeypatch.setattr(runtime, "_PLATFORM", None)
        monkeypatch.delenv(runtime.ENV_VAR, raising=False)
        assert runtime.platform_default_hint() is None
        runtime.seed_platform_default(None)
        assert str(runtime.default_device()) == "cuda"
        runtime.seed_platform_default("cpu")
        assert runtime.platform_default_hint() == "cpu"
        assert str(VetEngine("cuda").device) == "cpu"
        monkeypatch.setenv(runtime.ENV_VAR, "cuda")
        assert str(runtime.default_device()) == "cuda"

    def test_fused_gate_caps_window_length_at_the_kernel_limit(self):
        """An unbucketed engine gates the fused path only on the kernel's
        MAX_LMAX; longer windows take the gather path (the reference gates
        without limit)."""
        eng = VetEngine("cuda", buckets=None, device="cpu")
        ref = RefEngine("pallas", buckets=None)
        assert eng.fused_supported(4096) and ref.fused_supported(4096)
        assert not eng.fused_supported(4097) and ref.fused_supported(4097)
        s = sim_matrix(1, 4200)[0]
        res = eng.vet_sliding(s, 4100, 100)
        assert res.workers == 2 and eng.dispatches == 1
        assert eng.dispatch_bytes == 2 * 4100 * 8  # the gather matrix

    def test_fused_flag_routes_the_torch_backend_through_the_plain_kernel(self):
        s = stream(400, seed=8)
        fused = VetEngine("torch", buckets=64, device="cpu", fused=True)
        gather = VetEngine("torch", buckets=64, device="cpu")
        cuda = VetEngine("cuda", buckets=64, device="cpu")
        assert fused.fused_supported(128) and not gather.fused_supported(128)
        a = fused.vet_sliding(s, 128, 64)
        b = cuda.vet_sliding(s, 128, 64)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert fused.dispatch_bytes == cuda.dispatch_bytes

    def test_clone_forwards_the_unresolved_device(self):
        eng = VetEngine("torch", buckets=64, device="cpu", cache_size=3)
        c = eng.clone()
        assert (c.backend, c.buckets, c._device_arg, c._cache_size) == (
            "torch", 64, "cpu", 3)
        assert c.dispatches == 0 and c is not eng

    def test_invalidate_and_cache_clear(self):
        eng = VetEngine("torch", buckets=64, device="cpu")
        buf = np.linspace(1e-3, 2e-3, 16)
        eng.vet_batch(buf)
        assert eng.invalidate(buf) == 1
        eng.vet_batch(buf)
        eng.cache_clear()
        assert eng.cache_info() == (0, 0, 0, 128)

    def test_vet_one_and_task(self):
        eng = VetEngine("torch", buckets=64, device="cpu")
        r = eng.vet_one(np.linspace(1e-3, 2e-3, 16))
        assert r.n == 16 and float(r.vet) >= 1.0

    def test_default_engine_is_shared_and_defaults_to_cuda(self):
        a = default_engine()
        assert a is default_engine() and a.backend == "cuda"
        assert a.buckets == 64

    def test_errors_match_the_reference(self):
        for bad in (dict(backend="jax"), dict(cut_space="cubic")):
            with pytest.raises(ValueError):
                VetEngine(**bad)
        eng, ref = VetEngine("numpy"), RefEngine("numpy")
        for args in ((np.ones(8), 16), (np.ones(8), 1), (np.ones((2, 8)), 4)):
            with pytest.raises(ValueError):
                ref.vet_sliding(*args)
            with pytest.raises(ValueError):
                eng.vet_sliding(*args)
        with pytest.raises(ValueError):
            eng.vet_windows(np.ones(8), [])
        with pytest.raises(ValueError):
            eng.vet_many([])
