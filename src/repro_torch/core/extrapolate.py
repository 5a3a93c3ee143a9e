"""Monotone extrapolation of the ideal record-time curve g-hat (paper §4.3).

The port of ``repro.core.extrapolate``.  The paper's three-point filter
telescopes to a linear continuation with the local slope at the
change-point,

    g(t + j) = Y_t + j * (Y_t - Y_{t-1}),   j >= 0,

non-decreasing because the observations are sorted.  Functions work on the
last dimension of ``(..., n)`` tensors with one ``t`` per row; t is the
1-indexed size of the "normal" prefix.
"""

from __future__ import annotations

import torch

__all__ = ["ghat_curve", "local_slope"]


def _rows(y_sorted, t):
    y = torch.as_tensor(y_sorted).to(torch.float32)
    t = torch.as_tensor(t, dtype=torch.int64, device=y.device)
    return y, t.expand(y.shape[:-1]).unsqueeze(-1)


def local_slope(y_sorted, t, robust: bool = False) -> torch.Tensor:
    """Slope used for the continuation: Y_t - Y_{t-1} (paper), or the median
    of the last 5 pre-change-point diffs (``robust``) for noisy profiles."""
    y, t = _rows(y_sorted, t)
    n = y.shape[-1]
    i = torch.clamp(t - 1, 0, n - 1)  # 0-indexed position of Y_t
    if not robust:
        prev = torch.clamp(i - 1, 0, n - 1)
        diff = torch.gather(y, -1, i) - torch.gather(y, -1, prev)
        return torch.clamp(diff, min=0.0).squeeze(-1)
    d = torch.diff(y, dim=-1, prepend=y[..., :1])
    offs = torch.arange(5, device=y.device)
    window = torch.gather(d, -1, torch.clamp(i - offs, 0, n - 1))
    # jnp.median averages the two middle values of an even count; 5 is odd.
    return torch.clamp(window.median(dim=-1).values, min=0.0)


def ghat_curve(y_sorted, t, robust_slope: bool = False) -> torch.Tensor:
    """Full estimated-ideal curve g(x), x = 1..n:

        g(x) = Y_x                     for x <= t
        g(x) = Y_t + (x - t) * slope   for x >  t
    """
    y, tt = _rows(y_sorted, t)
    n = y.shape[-1]
    slope = local_slope(y, tt.squeeze(-1), robust=robust_slope).unsqueeze(-1)
    ranks = torch.arange(1, n + 1, device=y.device)
    y_t = torch.gather(y, -1, torch.clamp(tt - 1, 0, n - 1))
    extrap = y_t + slope * (ranks - tt).to(torch.float32)
    return torch.where(ranks <= tt, y, extrap)
