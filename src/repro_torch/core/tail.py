"""Heavy-tail diagnostics (paper §5.3): Hill estimator, Hill plot, emplot.

The port of ``repro.core.tail``.  The paper establishes that record
processing times are heavy-tailed (P(X > x) ~ c x^{-alpha}, alpha ≈ 1.3 for
its read-map profiles) — finite mean, infinite variance — which is exactly
why a lower-bound estimate must cut the tail off statistically rather than
average it.

Everything runs in float32 on the resolved device (``kernels.runtime``: the
card unless the caller asks for the CPU), as the reference runs in float32.
Logs are ``xla_order_log`` and prefix sums ``xla_order_cumsum``, the orders
in which XLA on the CPU rounds ``jnp.log`` and adds ``jnp.cumsum``, so
``hill_plot`` and ``emplot`` equal the reference bit for bit, on the CPU and
on the card.  Means and sums add in PyTorch's order: ``hill_estimator`` and
``tail_report`` agree with the reference to ~1e-7 relative.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .changepoint import xla_order_cumsum, xla_order_log
from .stats import as_x32

__all__ = ["hill_estimator", "hill_plot", "emplot", "TailReport", "tail_report"]


def _sorted_desc(x, device=None) -> torch.Tensor:
    return torch.sort(as_x32(x, device).float(), descending=True).values


def hill_estimator(x, k: int, *, device=None) -> torch.Tensor:
    """Hill tail-index estimate using the k largest observations.

    alpha-hat(k) = [ (1/k) sum_{i=1..k} (log Y_{n+1-i} - log Y_{n-k}) ]^{-1}

    (The paper's displayed formula gives 1/alpha — the average log-excess; we
    return alpha itself, matching its quoted "alpha around 1.3".)
    """
    y = _sorted_desc(x, device)
    top = xla_order_log(y[:k])
    ref = xla_order_log(y[k])
    gamma = torch.mean(top - ref)  # = 1/alpha
    return 1.0 / gamma


def hill_plot(x, k_max: Optional[int] = None, *, device=None):
    """(k, alpha-hat(k)) pairs for k = 2..k_max (vectorized, O(n))."""
    y = _sorted_desc(x, device)
    n = y.shape[0]
    if k_max is None:
        k_max = n - 1
    k_max = min(k_max, n - 1)
    logs = xla_order_log(y)
    csum = xla_order_cumsum(logs)
    ks = torch.arange(2, k_max + 1, device=y.device)
    gamma = csum[ks - 1] / ks.float() - logs[ks]
    return ks.to(torch.int32), 1.0 / gamma


def emplot(x, *, device=None):
    """Tail empirical-distribution plot data: (log y_i, log(1 - F-hat(y_i))).

    Heavy tails appear linear with slope -alpha.
    """
    y = torch.sort(as_x32(x, device).float()).values
    n = y.shape[0]
    # Survival at the i-th order statistic: (n - i) / n, drop the last point.
    i = torch.arange(1, n + 1, dtype=torch.int32, device=y.device)
    surv = (n - i).float() / float(n)
    return xla_order_log(y[:-1]), xla_order_log(surv[:-1])


class TailReport(NamedTuple):
    alpha: float
    alpha_stable_band: tuple  # (lo, hi) of alpha-hat over the stable k range
    emplot_slope: float  # OLS slope of emplot (should be ~ -alpha)
    heavy: bool  # alpha < 2  =>  infinite variance


def tail_report(x, k_frac: float = 0.1, *, device=None) -> TailReport:
    """Summarize the tail: point estimate at k = k_frac*n, stability band over
    k in [5%, 20%] of n, and the emplot OLS slope as a cross-check."""
    x = as_x32(x, device).float()  # moved once; the helpers keep its device
    n = int(x.shape[0])
    k = max(2, int(n * k_frac))
    alpha = float(hill_estimator(x, k, device=x.device))
    ks, alphas = hill_plot(x, k_max=max(3, int(n * 0.2)), device=x.device)
    lo_i = max(0, int(n * 0.05) - 2)
    band = alphas[lo_i:]
    lx, ls = emplot(x, device=x.device)
    # OLS slope over the top half of the tail.
    h = lx.shape[0] // 2
    lx_t, ls_t = lx[h:], ls[h:]
    lx_c = lx_t - torch.mean(lx_t)
    denom = torch.sum(lx_c * lx_c)
    slope = float(torch.sum(lx_c * (ls_t - torch.mean(ls_t)))
                  / torch.where(denom > 0, denom, 1.0))
    return TailReport(
        alpha=alpha,
        alpha_stable_band=(float(torch.min(band)), float(torch.max(band))),
        emplot_slope=slope,
        heavy=alpha < 2.0,
    )
