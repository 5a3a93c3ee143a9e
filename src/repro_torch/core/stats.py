"""Statistical utilities used by the paper's evaluation (§4.4, §5), in PyTorch.

The port of ``repro.core.stats``:

- Two-sample Kolmogorov-Smirnov test (paper Fig. 6: are vet_task samples of two
  same-config jobs from the same population?)  D statistic + asymptotic p-value
  via the Kolmogorov distribution series (Massey 1951 [12]).  A host
  statistic in float64 numpy, as in the reference: the same operations, so
  D and p equal the reference's bit for bit.
- Pearson correlation (paper Fig. 14: vet_task vs task processing time).
- 1000-bucket aggregation used by the paper's distribution figures (Fig. 8).

``pearson`` and ``bucketize`` run in float32 on the resolved device
(``kernels.runtime``: the card unless the caller asks for the CPU), as the
reference runs them in float32 (JAX's default, x64 off).  Their reductions
add in PyTorch's order, not XLA's: they agree with the reference to ~1e-7
relative, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import runtime

__all__ = ["ks_2samp", "KSResult", "pearson", "bucketize"]


class KSResult(NamedTuple):
    statistic: float
    pvalue: float


def _kolmogorov_sf(x: float, terms: int = 101) -> float:
    """Survival function of the Kolmogorov distribution,
    Q(x) = 2 sum_{j>=1} (-1)^{j-1} exp(-2 j^2 x^2)."""
    if x <= 0:
        return 1.0
    j = np.arange(1, terms, dtype=np.float64)
    s = 2.0 * np.sum((-1.0) ** (j - 1) * np.exp(-2.0 * (j * x) ** 2))
    return float(min(max(s, 0.0), 1.0))


def _counts_at(x: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """``np.searchsorted(x, pts, side="right")`` for sorted ``x`` and
    ``pts``, in O(len(x) + len(pts)) when ``pts`` is the longer: each
    ``x[i]`` is at or below ``pts[j]`` exactly when ``j`` reaches the first
    ``pts`` position at or above it (NaN sorts last, as in numpy)."""
    if pts.size <= x.size:
        return np.searchsorted(x, pts, side="right")
    first = np.searchsorted(pts, x, side="left")
    return np.cumsum(np.bincount(first, minlength=pts.size + 1))[:pts.size]


def _counts_at_self(x: np.ndarray) -> np.ndarray:
    """``np.searchsorted(x, x, side="right")`` for sorted ``x`` in O(n): the
    end of each run of equal values (NaNs one run, as numpy orders them)."""
    same = x[1:] == x[:-1]
    if x.size and np.isnan(x[-1]):  # sorted: any NaN is at the end
        same |= np.isnan(x[1:]) & np.isnan(x[:-1])
    if not same.any():
        return np.arange(1, x.size + 1)
    ends = np.flatnonzero(np.append(~same, True))
    return np.repeat(ends + 1, np.diff(ends, prepend=-1))


def ks_2samp(a, b) -> KSResult:
    """Two-sample KS test (asymptotic p-value, two-sided).

    D is the largest CDF gap over the points of both samples, as in the
    reference; the counts behind each CDF value are taken from the sorted
    samples in linear time (the same integers, so the same D), which keeps a
    sample against a pooled fleet profile cheap (``sched.straggler``)."""
    a = np.sort(np.asarray(a, dtype=np.float64))
    b = np.sort(np.asarray(b, dtype=np.float64))
    na, nb = a.size, b.size
    if na == 0 or nb == 0:
        raise ValueError("empty sample")
    d = 0.0
    for pts, own_a, own_b in ((a, True, False), (b, False, True)):
        cdf_a = (_counts_at_self(a) if own_a else _counts_at(a, pts)) / na
        cdf_b = (_counts_at_self(b) if own_b else _counts_at(b, pts)) / nb
        d = max(d, float(np.max(np.abs(cdf_a - cdf_b))))
    en = np.sqrt(na * nb / (na + nb))
    p = _kolmogorov_sf((en + 0.12 + 0.11 / en) * d)
    return KSResult(statistic=d, pvalue=p)


def as_x32(x, device=None) -> torch.Tensor:
    """``x`` as the reference's x64-off ``jnp.asarray`` makes it: floats in
    float32, integers in int32, on the resolved ``device``."""
    if not torch.is_tensor(x):
        x = np.asarray(x)
        x = x if x.flags.writeable else x.copy()  # frozen engine results
    t = torch.as_tensor(x)
    dtype = torch.float32 if t.is_floating_point() else torch.int32
    dev = runtime.require_device(runtime.resolve_device(device))
    return t.to(device=dev, dtype=dtype)


def pearson(x, y, *, device=None) -> float:
    x = as_x32(x, device).float()
    y = as_x32(y, device).float()
    xc = x - torch.mean(x)
    yc = y - torch.mean(y)
    denom = torch.sqrt(torch.sum(xc * xc) * torch.sum(yc * yc))
    return float(torch.sum(xc * yc) / torch.where(denom > 0, denom, 1.0))


def bucketize(times, n_buckets: int = 1000, *, device=None) -> torch.Tensor:
    """Paper Fig. 8 view: sort records by processing time, split into
    ``n_buckets`` rank buckets, return the per-bucket *sum* of times (a
    tensor on the resolved device; zeros pad the last buckets when
    ``n_buckets`` does not divide the record count)."""
    y = torch.sort(as_x32(times, device)).values
    n = y.shape[0]
    if n % n_buckets != 0:
        pad = n_buckets - n % n_buckets
        y = torch.cat([y, torch.zeros((pad,), dtype=y.dtype, device=y.device)])
    return torch.sum(y.reshape(n_buckets, -1), dim=1, dtype=y.dtype)
