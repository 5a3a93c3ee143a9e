"""Plain vet of one window of record times, from the paper's definition.

``PR = sum Y``; the records sorted, the change-point ``t`` is the prefix
size whose two least-squares lines (record rank against the log of the
time) leave the least summed squared error, over prefixes of ``omega`` to
``m - omega`` points of the curve (the lowest prefix wins a tie); with
``buckets`` and at least ``4 * buckets`` records the curve is the bucket
means, else the records.  ``EI`` keeps the first ``t`` records and puts
``g(r) = Y_t + (r - t) * max(Y_t - Y_{t-1}, 0)`` (at most ``Y_r``) after
them (on bucket means, the slope per record); ``vet = PR / EI``.

``dtype`` is the precision of every step: float64 for the reference,
bfloat16 for the check's control.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["landscape", "vet_window"]


def _curve(times, dtype, buckets: Optional[int]):
    y = torch.sort(torch.as_tensor(times, dtype=torch.float64).to(dtype)).values
    n = y.shape[0]
    if buckets is not None and n >= 4 * buckets:
        per = n // buckets
        return y, y[:per * buckets].view(buckets, per).mean(dim=-1), per
    return y, y, 1


def landscape(times, *, omega: int = 3, buckets: Optional[int] = 64,
              dtype=torch.float64) -> torch.Tensor:
    """SSE of the two-line fit for each prefix size k = 1..m of the curve
    (inf where k lies outside [omega, m - omega])."""
    _, curve, _ = _curve(times, dtype, buckets)
    z = torch.log(torch.clamp(curve, min=1e-12))
    m = z.shape[0]
    x = torch.arange(1, m + 1, dtype=dtype)
    sse = torch.full((m,), torch.inf, dtype=dtype)

    def fit(xs, zs):
        dx, dz = xs - xs.mean(), zs - zs.mean()
        sxx, sxz = (dx * dx).sum(), (dx * dz).sum()
        return (dz * dz).sum() - sxz * sxz / sxx

    for k in range(omega, m - omega + 1):
        sse[k - 1] = fit(x[:k], z[:k]) + fit(x[k:], z[k:])
    return sse


def vet_window(times, *, omega: int = 3, buckets: Optional[int] = 64,
               dtype=torch.float64, t: Optional[int] = None) -> dict:
    """{"vet", "ei", "pr", "t"} of one window's record times; ``t`` (a
    record-rank prefix size) evaluates at that cut instead of this side's
    own."""
    y, curve, per = _curve(times, dtype, buckets)
    m = curve.shape[0]
    if t is None:
        if m < 2 * omega:
            tb = 1
        else:
            sse = landscape(times, omega=omega, buckets=buckets, dtype=dtype)
            tb = int(torch.argmin(sse)) + 1
        t = tb * per
    tb = t // per
    i = min(max(tb - 1, 1), m - 1)
    anchor = curve[i]
    slope = torch.clamp(curve[i] - curve[i - 1], min=0.0) / per
    ranks = torch.arange(1, y.shape[0] + 1, dtype=dtype)
    g = torch.minimum(anchor + slope * (ranks - t), y)
    ei = torch.where(ranks <= t, y, g).sum()
    pr = y.sum()
    return {"vet": float(pr / ei), "ei": float(ei), "pr": float(pr), "t": t}
