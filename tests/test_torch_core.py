"""``repro_torch.core`` against ``repro.core`` on the same inputs.

Inputs are made with numpy from a seed and handed to both packages as numpy
arrays; JAX runs on the CPU.  Tolerances (see ``torch_port_contract``):
vet/ei/oc/pr to 1e-5 where the cut agrees, near-tie cuts within 1e-4 on the
reference's landscape, identical cuts on noiseless rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as ref
import repro.core.changepoint as ref_cp
import repro_torch.core as port
import repro_torch.core.changepoint as port_cp
from repro.profiling import simulate_records as ref_simulate
from repro_torch.profiling import simulate_job, simulate_records

from torch_port_contract import (assert_contract, cut_gap, noiseless_matrix,
                                 sim_matrix)


def log_curves(rows, n, seed=0):
    return np.log(np.sort(sim_matrix(rows, n, seed), axis=1)).astype(np.float32)


def ref_results(times, **kw):
    r = ref.vet_task(jnp.asarray(times), **kw)
    return {k: float(getattr(r, k)) for k in ("vet", "ei", "oc", "pr", "t")}


# ----------------------------------------------------------- changepoint
class TestChangepoint:
    @pytest.mark.parametrize("n", [64, 256, 1000])
    def test_landscape_matches_reference(self, n):
        """Same +inf mask; finite entries within 1e-3 of the landscape's
        scale: the SSE is a difference of f32 prefix sums that cancel, and
        the two packages' cumsums round differently."""
        for z in log_curves(4, n, seed=n):
            a = np.asarray(ref_cp.two_segment_sse(jnp.asarray(z)))
            b = port_cp.two_segment_sse(torch.from_numpy(z)).numpy()
            fin = np.isfinite(a)
            np.testing.assert_array_equal(fin, np.isfinite(b))
            scale = np.abs(a[fin]).max()
            assert np.abs(a[fin] - b[fin]).max() <= 1e-3 * scale

    @pytest.mark.parametrize("n", [64, 256, 1000])
    def test_cut_matches_reference_under_contract(self, n):
        z = log_curves(16, n, seed=3 * n)
        t_port = port.estimate_changepoint(torch.from_numpy(z)).numpy()
        assert t_port.dtype == np.int32 and t_port.shape == (16,)
        for i, row in enumerate(z):
            t_ref = int(ref.estimate_changepoint(jnp.asarray(row)))
            if t_port[i] != t_ref:
                assert cut_gap(row, int(t_port[i]), t_ref) <= 1e-4

    def test_batched_rows_equal_single_rows(self):
        """The batch dimension is written out: row i of a batched call is
        bitwise the single-row call."""
        z = torch.from_numpy(log_curves(6, 300, seed=9))
        batched = port_cp.two_segment_sse(z)
        for i in range(6):
            torch.testing.assert_close(batched[i], port_cp.two_segment_sse(z[i]),
                                       rtol=0, atol=0)

    def test_index_closed_forms_are_the_reference_arrays(self):
        for n in (6, 1000, 8192):
            for a, b in zip(port_cp.index_closed_forms(n),
                            ref_cp.index_closed_forms(n)):
                np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("n,omega", [(1, 3), (5, 3), (7, 4), (1, 1)])
    def test_short_input_raises_and_naive_returns_sentinel(self, n, omega):
        y = torch.linspace(1.0, 2.0, n)
        with pytest.raises(ValueError, match="2\\*omega"):
            port.estimate_changepoint(y, omega=omega)
        assert port.estimate_changepoint_naive(np.ones(n), omega=omega) == -1

    def test_boundary_n_exactly_2omega_is_valid(self):
        y = np.concatenate([np.ones(3), np.full(3, 5.0)])
        assert port.estimate_changepoint_naive(y) == 3
        assert int(port.estimate_changepoint(torch.tensor(y))) == 3

    def test_large_n_tracks_f64_oracle(self):
        """n=8192 Pareto-tail curve (``tests/test_changepoint_edges.py``):
        f64 closed forms and centred prefix sums keep the f32 cut within 4
        samples of the O(n^2) f64 oracle, as in the reference."""
        rng = np.random.default_rng(0)
        k = int(0.7 * 8192)
        y = np.sort(np.concatenate([rng.normal(1.0, 0.02, k),
                                    3.0 + rng.pareto(1.5, 8192 - k)]))
        t_naive = port.estimate_changepoint_naive(y)
        assert t_naive == ref.estimate_changepoint_naive(y)
        t = int(port.estimate_changepoint(torch.from_numpy(y.astype(np.float32))))
        assert abs(t - t_naive) <= 4

    @pytest.mark.parametrize("scale", [7.5, 1e3])
    def test_scale_equivariance_large_n(self, scale):
        rng = np.random.default_rng(3)
        k = int(0.7 * 4096)
        y = np.sort(np.concatenate([rng.normal(1.0, 0.02, k),
                                    3.0 + rng.pareto(1.5, 4096 - k)]))
        t1 = int(port.estimate_changepoint(torch.tensor(y, dtype=torch.float32)))
        t2 = int(port.estimate_changepoint(
            torch.tensor(y * scale, dtype=torch.float32)))
        assert abs(t1 - t2) <= 1


# ------------------------------------------------- XLA's order on the CPU
CUMSUM_NS = [1, 5, 16, 17, 64, 100, 255, 256, 257, 1000, 1023, 1024, 4000,
             4096, 8192, 65536]


class TestXlaOrder:
    """``xla_order_cumsum`` and ``xla_order_log`` add and round as XLA on
    the CPU does for ``jnp.cumsum`` and ``jnp.log``: bitwise equal."""

    @pytest.mark.parametrize("n", CUMSUM_NS)
    def test_cumsum_is_bitwise_jnp_1d(self, n):
        rng = np.random.default_rng(n)
        for _ in range(5):
            a = (rng.standard_normal(n) * rng.uniform(0.1, 100)).astype(
                np.float32)
            np.testing.assert_array_equal(
                port_cp.xla_order_cumsum(torch.from_numpy(a)).numpy(),
                np.asarray(jnp.cumsum(jnp.asarray(a))))

    @pytest.mark.parametrize("axis", [0, 1, -1])
    def test_cumsum_is_bitwise_jnp_2d(self, axis):
        a = np.random.default_rng(8).standard_normal((8, 1000)).astype(
            np.float32)
        got = port_cp.xla_order_cumsum(torch.from_numpy(a), dim=axis)
        assert got.is_contiguous()
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jnp.cumsum(jnp.asarray(a), axis=axis)))

    @pytest.mark.parametrize("n", [64, 1000, 8192])
    def test_kernel_operands_are_contiguous(self, n):
        """The plain decomposition's operands (``prefix_inputs``) are
        contiguous: the XLA-order scan slices its zero-padded tail away."""
        from repro_torch.kernels.changepoint.ops import prefix_inputs
        z = torch.from_numpy(log_curves(3, n, seed=n))
        cy, cyy, cxy, totals, forms = prefix_inputs(z)
        assert all(t.is_contiguous() for t in (cy, cyy, cxy, totals, *forms))

    @pytest.mark.parametrize("lo,hi", [(1e-40, 1e-30), (1e-12, 1e-6),
                                       (1e-6, 1e3), (0.5, 2.0), (1e3, 3e38)])
    def test_log_is_bitwise_jnp(self, lo, hi):
        rng = np.random.default_rng(int(-np.log10(lo)) + 50)
        a = np.exp(rng.uniform(np.log(lo), np.log(hi), 20000)).astype(
            np.float32)
        a = np.concatenate([a, [0.0, -1.0, np.inf, np.nan, 1.0]]).astype(
            np.float32)
        np.testing.assert_array_equal(
            port_cp.xla_order_log(torch.from_numpy(a)).numpy(),
            np.asarray(jnp.log(jnp.asarray(a))))

    @pytest.mark.parametrize("buckets,n", [(1000, 4000), (1000, 8192),
                                           (64, 512), (64, 1024),
                                           (None, 256), (None, 1024)])
    @pytest.mark.parametrize("cut_space", ["log", "raw"])
    def test_torch_backend_cut_is_the_references(self, buckets, n,
                                                 cut_space):
        """Every row's cut equals the reference's (the settings of
        ``tests/torch_port_cut_flips.py``, all at 0 flips), and vet/ei/oc/pr
        agree to 1e-5."""
        from repro.engine import VetEngine as RefEngine
        from repro_torch.engine import VetEngine
        m = sim_matrix(24, n, seed=n + 5)
        want = RefEngine("jax", buckets=buckets,
                         cut_space=cut_space).vet_batch(m)
        got = VetEngine("torch", buckets=buckets, cut_space=cut_space,
                        device="cpu").vet_batch(m)
        np.testing.assert_array_equal(got.t, want.t)
        for name in ("vet", "ei", "oc", "pr"):
            np.testing.assert_allclose(getattr(got, name),
                                       getattr(want, name), rtol=1e-5)


# ----------------------------------------------------------- extrapolate
class TestExtrapolate:
    @pytest.mark.parametrize("robust", [False, True])
    def test_ghat_and_slope_match_reference(self, robust):
        """Elementwise f32 arithmetic on the same inputs: bitwise."""
        y = np.sort(simulate_records(200, seed=5).times).astype(np.float32)
        for t in (1, 2, 57, 200):
            np.testing.assert_array_equal(
                port.ghat_curve(torch.from_numpy(y), t, robust_slope=robust)
                .numpy(),
                np.asarray(ref.ghat_curve(jnp.asarray(y), t,
                                          robust_slope=robust)))
            assert float(port.local_slope(torch.from_numpy(y), t,
                                          robust=robust)) == float(
                ref.local_slope(jnp.asarray(y), t, robust=robust))


# ------------------------------------------------------------------- vet
ESTIMATORS = [(b, c) for b in (None, 64, 1000) for c in ("log", "raw")]


class TestVetPipeline:
    @pytest.mark.parametrize("buckets,cut_space", ESTIMATORS)
    def test_vet_task_matches_reference(self, buckets, cut_space):
        # Long enough to bucket at 64 (>= 256) and at 1000 (>= 4000).
        n = {None: 256, 64: 512, 1000: 4096}[buckets]
        m = sim_matrix(4, n, seed=17)
        kw = dict(buckets=buckets, cut_space=cut_space)
        got = [port.vet_task(row, **kw) for row in m]
        want = [ref_results(row, **kw) for row in m]
        assert_contract(
            {k: [float(getattr(r, k)) for r in got] for k in want[0]},
            {k: [w[k] for w in want] for k in want[0]},
            lambda i: m[i], buckets, cut_space,
            f"vet_task {buckets}/{cut_space}")
        assert all(r.n == n for r in got)

    @pytest.mark.parametrize("buckets,cut_space", ESTIMATORS)
    def test_batched_pipeline_matches_reference(self, buckets, cut_space):
        n = {None: 128, 64: 256, 1000: 4000}[buckets]
        m = sim_matrix(8, n, seed=23)
        vet, ei, oc, pr, t = port.vet_pipeline(torch.from_numpy(m),
                                               buckets=buckets,
                                               cut_space=cut_space)
        assert vet.shape == (8,) and t.dtype == torch.int32
        want = [ref_results(row, buckets=buckets, cut_space=cut_space)
                for row in m]
        assert_contract(
            {"vet": vet.numpy(), "ei": ei.numpy(), "oc": oc.numpy(),
             "pr": pr.numpy(), "t": t.numpy()},
            {k: [w[k] for w in want] for k in want[0]},
            lambda i: m[i], buckets, cut_space,
            f"vet_pipeline {buckets}/{cut_space}")

    def test_noiseless_cut_is_identical(self):
        m = noiseless_matrix()
        for row in m:
            assert int(port.vet_task(row, buckets=None).t) == int(
                ref.vet_task(jnp.asarray(row), buckets=None).t)

    @pytest.mark.parametrize("n", [2, 3, 5])
    def test_degenerate_profile_falls_back_to_t1(self, n):
        row = simulate_records(n, seed=n).times
        got = port.vet_task(row, buckets=None)
        want = ref_results(row, buckets=None)
        assert int(got.t) == want["t"] == 1
        np.testing.assert_allclose(float(got.vet), want["vet"], rtol=1e-5)

    def test_identities_hold(self):
        """EI + OC = PR, vet >= 1, per row (f32 sums: 1e-5)."""
        vet, ei, oc, pr, _ = port.vet_pipeline(
            torch.from_numpy(sim_matrix(6, 512, seed=2)), buckets=64)
        torch.testing.assert_close(ei + oc, pr, rtol=1e-5, atol=0)
        assert bool((vet >= 1.0 - 1e-6).all())

    def test_ei_oc_default_extrapolation_matches_reference(self):
        y = np.sort(simulate_records(300, seed=8).times).astype(np.float32)
        for t in (3, 150, 297):
            ei, oc = port.ei_oc(torch.from_numpy(y), t)
            ei_r, oc_r = ref.ei_oc(jnp.asarray(y), t)
            np.testing.assert_allclose(float(ei), float(ei_r), rtol=1e-5)
            np.testing.assert_allclose(float(oc), float(oc_r), rtol=1e-5)

    def test_bad_cut_space_rejected(self):
        with pytest.raises(ValueError, match="cut_space"):
            port.vet_pipeline(np.ones(16), cut_space="cubic")

    def test_vet_job_matches_reference(self):
        profiles = [simulate_records(n, seed=n).times for n in (300, 512, 700)]
        got = port.vet_job(profiles, buckets=64)
        want = ref.vet_job([jnp.asarray(p) for p in profiles], buckets=64)
        assert_contract(
            {k: [float(getattr(r, k)) for r in got.tasks] for k in
             ("vet", "ei", "oc", "pr", "t")},
            {k: [float(getattr(r, k)) for r in want.tasks] for k in
             ("vet", "ei", "oc", "pr", "t")},
            lambda i: profiles[i], 64, "log", "vet_job tasks")
        np.testing.assert_allclose(
            float(got.vet_job),
            np.mean([float(r.vet) for r in got.tasks]), rtol=1e-6)
        np.testing.assert_allclose(float(got.pr_mean), float(want.pr_mean),
                                   rtol=1e-5)
        with pytest.raises(ValueError):
            port.vet_job([])


# ------------------------------------------------------------- simulator
class TestSimulator:
    @pytest.mark.parametrize("seed", [0, 1, 7, 1023])
    def test_simulate_records_is_bitwise_the_reference(self, seed):
        a, b = simulate_records(777, seed=seed), ref_simulate(777, seed=seed)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    def test_simulate_job_is_bitwise_the_reference(self):
        from repro.profiling import simulate_job as ref_job
        for a, b in zip(simulate_job(3, 100, utilization_factor=2.0, seed=4),
                        ref_job(3, 100, utilization_factor=2.0, seed=4)):
            np.testing.assert_array_equal(a.times, b.times)
