"""``repro_torch.core.stats`` and ``repro_torch.core.tail`` against the
reference (``repro.core.stats``, ``repro.core.tail``), on the CPU.

- ``ks_2samp`` is the reference's float64 numpy statistic: D and p bit for
  bit, the empty-sample ``ValueError`` included.
- ``hill_plot`` and ``emplot`` equal the reference bit for bit on a
  65,536-record ``simulate_records`` profile: float32 throughout, logs in
  ``xla_order_log`` and prefix sums in ``xla_order_cumsum`` (XLA's CPU
  rounding and order).
- Means and sums add in PyTorch's order, not XLA's (no cheap rule
  reproduces XLA's CPU reduction order), so ``hill_estimator``,
  ``tail_report``, ``pearson`` and ``bucketize`` are held to 1e-6 relative,
  a few f32 roundings of the sum; ``heavy`` is equal.
"""

import numpy as np
import pytest
import torch

import repro.core.stats as ref_stats
import repro.core.tail as ref_tail
from repro_torch.core import (KSResult, TailReport, bucketize, emplot,
                              hill_estimator, hill_plot, ks_2samp, pearson,
                              tail_report)
from repro_torch.kernels import runtime
from repro_torch.profiling import simulate_records

RTOL = 1e-6


@pytest.fixture(scope="module")
def job_profile():
    """One task of the smoke's job: 65,536 records."""
    return simulate_records(65536, seed=3).times


def samples():
    rng = np.random.default_rng(7)
    return {
        "pareto": rng.pareto(1.3, 50_000) + 1.0,
        "light": np.abs(rng.normal(0, 1, 30_000)) + 1.0,
    }


# ------------------------------------------------------------------ tail
@pytest.mark.parametrize("k_max", [None, 13107, 2, 1])
def test_hill_plot_is_bitwise(job_profile, k_max):
    ks, alphas = hill_plot(job_profile, k_max=k_max, device="cpu")
    ref_ks, ref_alphas = ref_tail.hill_plot(job_profile, k_max=k_max)
    assert ks.dtype == torch.int32 and alphas.dtype == torch.float32
    np.testing.assert_array_equal(ks.numpy(), np.asarray(ref_ks))
    np.testing.assert_array_equal(alphas.numpy(), np.asarray(ref_alphas))


def test_emplot_is_bitwise(job_profile):
    lx, ls = emplot(job_profile, device="cpu")
    ref_lx, ref_ls = ref_tail.emplot(job_profile)
    assert lx.dtype == ls.dtype == torch.float32
    np.testing.assert_array_equal(lx.numpy(), np.asarray(ref_lx))
    np.testing.assert_array_equal(ls.numpy(), np.asarray(ref_ls))


@pytest.mark.parametrize("k", [2, 100, 6553, 65535])
def test_hill_estimator(job_profile, k):
    got = hill_estimator(job_profile, k, device="cpu")
    want = float(ref_tail.hill_estimator(job_profile, k))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(want, rel=RTOL)


def test_hill_estimator_recovers_pareto_alpha():
    rng = np.random.default_rng(0)
    for alpha in (1.3, 2.0):
        x = rng.pareto(alpha, 300_000) + 1.0
        est = float(hill_estimator(x, 30_000, device="cpu"))
        assert abs(est - alpha) / alpha < 0.1, (alpha, est)


@pytest.mark.parametrize("name", ["job", "pareto", "light"])
def test_tail_report(job_profile, name):
    x = job_profile if name == "job" else samples()[name]
    got = tail_report(x, device="cpu")
    want = ref_tail.tail_report(x)
    assert isinstance(got, TailReport)
    assert isinstance(got.alpha, float) and isinstance(got.heavy, bool)
    assert got.heavy == want.heavy
    assert got.alpha == pytest.approx(want.alpha, rel=RTOL)
    assert got.alpha_stable_band == pytest.approx(want.alpha_stable_band,
                                                  rel=RTOL)
    assert got.emplot_slope == pytest.approx(want.emplot_slope, rel=RTOL)
    # The reference's own checks (tests/test_tail_profiling.py).
    if name == "pareto":
        assert got.heavy and 1.1 < got.alpha < 1.5
        assert abs(-got.emplot_slope - got.alpha) < 0.3
    if name == "light":
        assert got.alpha > 2.0


def test_tail_takes_a_tensor_of_integers():
    x = np.random.default_rng(2).integers(1, 1000, 4096)
    np.testing.assert_array_equal(
        hill_plot(torch.as_tensor(x), device="cpu")[1].numpy(),
        np.asarray(ref_tail.hill_plot(x)[1]))


# ----------------------------------------------------------------- stats
KS_CASES = {
    "same_population": lambda r: (r.pareto(1.3, 800), r.pareto(1.3, 800)),
    "shifted": lambda r: (r.normal(0, 1, 800), r.normal(1.0, 1, 800)),
    "ragged": lambda r: (r.exponential(1.0, 37), r.exponential(1.2, 4096)),
    "ties": lambda r: (r.integers(0, 5, 300), r.integers(0, 6, 200)),
    "identical": lambda r: (np.arange(10.0), np.arange(10.0)),
    "one_each": lambda r: (np.array([1.0]), np.array([2.0])),
    "nan": lambda r: (np.where(r.random(50) < 0.2, np.nan, r.normal(size=50)),
                      np.where(r.random(90) < 0.2, np.nan,
                               r.integers(0, 3, 90))),
    # sched.straggler's case: one worker's window against the pooled fleet
    "pooled": lambda r: (lambda x: (x[:200] * 1.5, x))(r.pareto(1.3, 20_000)),
}


@pytest.mark.parametrize("case", sorted(KS_CASES))
def test_ks_2samp_is_bitwise(case):
    a, b = KS_CASES[case](np.random.default_rng(3))
    got, want = ks_2samp(a, b), ref_stats.ks_2samp(a, b)
    assert isinstance(got, KSResult)
    np.testing.assert_array_equal([got.statistic, got.pvalue],
                                  [want.statistic, want.pvalue])


def test_ks_2samp_population_verdicts():
    rng = np.random.default_rng(3)
    assert ks_2samp(rng.pareto(1.3, 800), rng.pareto(1.3, 800)).pvalue > 0.05
    rng = np.random.default_rng(4)
    assert ks_2samp(rng.normal(0, 1, 800),
                    rng.normal(1.0, 1, 800)).pvalue < 1e-6


@pytest.mark.parametrize("a,b", [([], [1.0]), ([1.0], []), ([], [])])
def test_ks_2samp_empty_sample(a, b):
    with pytest.raises(ValueError, match="empty sample"):
        ks_2samp(a, b)
    with pytest.raises(ValueError, match="empty sample"):
        ref_stats.ks_2samp(a, b)


@pytest.mark.parametrize("kind", ["linear", "noisy", "anti", "heavy"])
def test_pearson(kind):
    rng = np.random.default_rng(11)
    x = rng.pareto(1.3, 1024) + 1.0
    y = {"linear": 3 * x + 1, "noisy": x + rng.normal(0, 2, x.size),
         "anti": -x, "heavy": x ** 0.5 * (rng.pareto(2.0, x.size) + 1)}[kind]
    got = pearson(x, y, device="cpu")
    assert isinstance(got, float)
    assert got == pytest.approx(ref_stats.pearson(x, y), rel=RTOL)


def test_pearson_of_a_constant_is_zero():
    x = np.arange(100.0)
    assert pearson(np.ones(100), x, device="cpu") == 0.0
    assert ref_stats.pearson(np.ones(100), x) == 0.0


@pytest.mark.parametrize("n,n_buckets", [(65536, 1000), (12_345, 1000),
                                         (64_000, 1000), (999, 10)])
def test_bucketize(n, n_buckets):
    x = np.random.default_rng(5).pareto(1.3, n)
    got = bucketize(x, n_buckets, device="cpu")
    want = np.asarray(ref_stats.bucketize(x, n_buckets))
    assert got.dtype == torch.float32 and got.shape == (n_buckets,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got.sum().item(), x.sum(), rtol=1e-5)


def test_bucketize_pads_with_zeros_and_keeps_integers():
    x = np.arange(1, 24)  # 23 records into 5 buckets: 2 zeros of padding
    got = bucketize(x, 5, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_stats.bucketize(x, 5)))
    np.testing.assert_array_equal(got.numpy(), [15, 40, 65, 90, 66])


def test_device_policy(monkeypatch):
    """``device=None`` follows ``REPRO_TORCH_DEVICE``; a ``cuda`` device
    with no card raises instead of falling back to the CPU."""
    monkeypatch.setenv(runtime.ENV_VAR, "cpu")
    assert bucketize(np.arange(10.0), 5).device.type == "cpu"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pearson(np.arange(4.0), np.arange(4.0), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tail_report(np.arange(1.0, 100.0), device="cuda")
