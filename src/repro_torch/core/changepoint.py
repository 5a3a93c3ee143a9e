"""Least-squares change-point estimation (paper §4.3), batched in PyTorch.

The port of ``repro.core.changepoint``.  Given sorted record times
``Y_1 <= ... <= Y_n`` the change-point ``t`` is

    t = argmin_{omega <= k <= n-omega}  SSE(Y[1:k]; linear) + SSE(Y[k+1:n]; linear)

with every segment SSE taken in O(1) from three prefix sums over y (y, y^2,
x*y) and the closed forms of the index sums.  Every function here works on
the last dimension of a ``(..., n)`` tensor: rows are independent profiles,
the batch dimension written out where the reference used ``vmap``.

Numerics follow the reference exactly in structure: f32 throughout, y
centred on the *element* ``y[(n-1)//2]`` before the prefix sums, and the
index closed forms evaluated in f64 and rounded once to f32.  The prefix sums
themselves are ``torch.cumsum``, whose f32 rounding is not ``jnp.cumsum``'s,
so the argmin may move between statistical near-ties (relative SSE gaps of
order 1e-4); the differential tests hold the port to that contract.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["centered_prefix_sums", "closed_forms_f32", "estimate_changepoint",
           "estimate_changepoint_naive", "index_closed_forms",
           "segment_sse_terms", "sse_from_prefix_sums", "two_segment_sse"]


def _promote(y) -> torch.Tensor:
    return torch.as_tensor(y).to(torch.float32)


def segment_sse_terms(n1, sx, sy, sxx, sxy, syy):
    """SSE of the best linear fit given raw segment sums (elementwise)."""
    n1 = torch.clamp(n1, min=1.0)
    sxx_c = sxx - sx * sx / n1
    sxy_c = sxy - sx * sy / n1
    syy_c = syy - sy * sy / n1
    # Degenerate segments (m < 2 or constant x) fall back to total variation.
    safe = sxx_c > 0.0
    sse = syy_c - torch.where(
        safe, sxy_c * sxy_c / torch.where(safe, sxx_c, 1.0), 0.0)
    # Guard tiny negative values from cancellation.
    return torch.clamp(sse, min=0.0)


def index_closed_forms(n: int):
    """Closed-form index sums Sx(k), Sxx(k) and their segment-2 complements
    for k = 1..n, in float64 (four numpy arrays of shape (n,)).

    Evaluating the cubic in f32 compounds rounding past the mantissa for n of
    a few thousand; callers round these once to f32 at the combine.
    """
    k = np.arange(1, n + 1, dtype=np.float64)
    sx1 = k * (k + 1.0) / 2.0
    sxx1 = k * (k + 1.0) * (2.0 * k + 1.0) / 6.0
    nf = float(n)
    sx_tot = nf * (nf + 1.0) / 2.0
    sxx_tot = nf * (nf + 1.0) * (2.0 * nf + 1.0) / 6.0
    return sx1, sxx1, sx_tot - sx1, sxx_tot - sxx1


def centered_prefix_sums(y_sorted: torch.Tensor):
    """``(cy, cyy, cxy)``: inclusive prefix sums over the last dimension of
    ``z = y - y[(n-1)//2]`` (an exact element pick, no reduction rounding),
    ``z^2`` and ``k * z`` with k = 1..n."""
    y = _promote(y_sorted)
    n = y.shape[-1]
    idx = torch.arange(1, n + 1, dtype=torch.float32, device=y.device)
    z = y - y[..., (n - 1) // 2:(n - 1) // 2 + 1]
    return (torch.cumsum(z, dim=-1), torch.cumsum(z * z, dim=-1),
            torch.cumsum(idx * z, dim=-1))


def sse_from_prefix_sums(cy, cyy, cxy, totals, forms, omega: int):
    """Two-segment SSE landscape from prefix sums.

    ``cy``/``cyy``/``cxy``: (..., n) f32; ``totals``: (..., 3) f32 =
    ``[cy[-1], cyy[-1], cxy[-1]]``; ``forms``: the four (n,) f32 index
    closed forms.  Entries outside ``omega <= k <= n - omega`` are +inf.
    """
    n = cy.shape[-1]
    sx1, sxx1, sx2, sxx2 = forms
    k = torch.arange(1, n + 1, dtype=torch.float32, device=cy.device)
    nf = torch.tensor(float(n), dtype=torch.float32, device=cy.device)
    tot_y, tot_yy, tot_xy = (totals[..., i:i + 1] for i in range(3))
    sse1 = segment_sse_terms(k, sx1, cy, sxx1, cxy, cyy)
    sse2 = segment_sse_terms(nf - k, sx2, tot_y - cy, sxx2, tot_xy - cxy,
                             tot_yy - cyy)
    valid = (k >= omega) & (k <= nf - omega)
    return torch.where(valid, sse1 + sse2, torch.inf)


def closed_forms_f32(n: int, device) -> tuple:
    """``index_closed_forms(n)`` rounded once to f32 tensors on ``device``."""
    return tuple(torch.as_tensor(a, dtype=torch.float32).to(device)
                 for a in index_closed_forms(n))


def two_segment_sse(y_sorted, omega: int = 3) -> torch.Tensor:
    """Total SSE for every candidate split k (1-indexed prefix size).

    ``sse[..., k-1]`` is the two-segment SSE for {Y_1..Y_k | Y_k+1..Y_n};
    entries outside the probing window are +inf (all of them when
    ``n < 2*omega``).
    """
    y = _promote(y_sorted)
    cy, cyy, cxy = centered_prefix_sums(y)
    totals = torch.stack([cy[..., -1], cyy[..., -1], cxy[..., -1]], dim=-1)
    return sse_from_prefix_sums(cy, cyy, cxy, totals,
                                closed_forms_f32(y.shape[-1], y.device), omega)


def estimate_changepoint(y_sorted, omega: int = 3) -> torch.Tensor:
    """The paper's t-hat per row: int32, 1-indexed size of the "normal"
    prefix, in ``[omega, n - omega]``; the lowest index wins a tie.

    Raises:
        ValueError: ``n < 2*omega`` — no split lies inside the probing
            window (the naive oracle returns ``-1`` for the same case).
    """
    y = _promote(y_sorted)
    n = y.shape[-1]
    if n < 2 * omega:
        raise ValueError(
            f"estimate_changepoint needs n >= 2*omega points to probe a "
            f"split (omega={omega} on each side), got n={n}")
    sse = two_segment_sse(y, omega=omega)
    return (torch.argmin(sse, dim=-1) + 1).to(torch.int32)


def estimate_changepoint_naive(y_sorted, omega: int = 3) -> int:
    """O(n^2) literal transcription of the paper's estimator (f64 oracle).

    Returns ``-1`` when no valid split exists (``n < 2*omega``).
    """
    y = np.asarray(y_sorted, dtype=np.float64)
    n = y.shape[0]
    x = np.arange(1, n + 1, dtype=np.float64)
    best_k, best = -1, np.inf
    for k in range(omega, n - omega + 1):
        sse = 0.0
        for (xs, ys) in ((x[:k], y[:k]), (x[k:], y[k:])):
            if xs.size >= 2:
                a = np.stack([np.ones_like(xs), xs], axis=1)
                coef, _, _, _ = np.linalg.lstsq(a, ys, rcond=None)
                r = ys - a @ coef
                sse += float(r @ r)
        if sse < best:
            best, best_k = sse, k
    return best_k
