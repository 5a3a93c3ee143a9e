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
are ``xla_order_cumsum`` and the log curve of ``core.vet`` is
``xla_order_log``: the orders in which XLA on the CPU adds ``jnp.cumsum`` and
rounds ``jnp.log``.  Both are bitwise ``jnp`` on the CPU, so the port's cuts
there are the reference's (``tests/torch_port_cut_flips.py``: 0 flips);
both are fixed sequences of IEEE operations, so they give the same bits on
CUDA.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["centered_prefix_sums", "closed_forms_f32", "estimate_changepoint",
           "estimate_changepoint_naive", "index_closed_forms",
           "segment_sse_terms", "sse_from_prefix_sums", "two_segment_sse",
           "xla_order_cumsum", "xla_order_log"]

_BLOCK = 16  # XLA's base for the blocked scan it lowers a cumsum to


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


def xla_order_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive prefix sum along ``dim``, adding in the order XLA uses for
    ``jnp.cumsum`` on the CPU: a recursive blocked scan with base 16.

    1. add serially inside blocks of 16 (the tail block padded with zeros);
    2. scan the blocks' last values by the same rule, recursively, until at
       most 16 remain;
    3. add each block the exclusive prefix of those totals.

    The serial adds are 15 explicit column adds, not ``torch.cumsum``, so
    every add is one IEEE operation in a fixed order and the result is the
    same on the CPU and on CUDA.
    """
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    nb = -(-n // _BLOCK)
    v = torch.nn.functional.pad(x, (0, nb * _BLOCK - n))
    v = v.reshape(*x.shape[:-1], nb, _BLOCK)
    cols = [v[..., 0]]
    for j in range(1, _BLOCK):
        cols.append(cols[-1] + v[..., j])
    c = torch.stack(cols, dim=-1)
    if nb > 1:
        tot = xla_order_cumsum(c[..., -1])
        c = c + torch.nn.functional.pad(tot[..., :-1], (1, 0)).unsqueeze(-1)
    out = c.reshape(*x.shape[:-1], nb * _BLOCK)[..., :n].movedim(-1, dim)
    return out.contiguous()  # the kernels take contiguous operands


def _fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, as a fused multiply-add rounds.

    The f32 product is exact in f64; the f64 sum is made round-to-odd (the
    f64 TwoSum error picks the odd neighbour when the sum was inexact), so
    the one rounding to f32 that follows is the correctly rounded result.
    """
    p = a.double() * torch.as_tensor(b, dtype=torch.float64, device=a.device)
    c = torch.as_tensor(c, device=a.device).double().expand_as(p)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even,
                    torch.nextafter(s, torch.where(err > 0, torch.inf,
                                                   -torch.inf)), s)
    return s.float()


# XLA's CPU log polynomial (Cephes, as Eigen's plog_float evaluates it):
# coefficients as f32, in evaluation order.
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRTHF = 0.707106781186547524


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def xla_order_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of f32 values, computed as XLA computes ``jnp.log`` on an
    x86-64 CPU with FMA: the Cephes range reduction and polynomial, with the
    multiply-adds the compiler fuses rounded once (``_fma_f32``).

    Bitwise ``jnp.log`` for every f32 input: subnormal input counts as
    zero, as XLA's CPU code flushes it; zero, negative, infinite and NaN
    input take ``torch.log``'s value.  The same on the CPU and on CUDA:
    every step is one IEEE operation in a fixed order.
    """
    x = torch.as_tensor(x).to(torch.float32)
    dev = x.device
    tiny = float(torch.finfo(torch.float32).tiny)
    x = torch.where(x.abs() < tiny, 0.0, x)
    bits = torch.clamp(x, min=tiny).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & -0x7F800001) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = m < _f32(_SQRTHF, dev)
    e = e - low.to(torch.float32)
    r = (m - 1.0) + torch.where(low, m, 0.0)
    r2 = r * r
    r3 = r2 * r
    p = [_f32(c, dev) for c in _LOG_P]
    y0 = _fma_f32(r, p[0], p[1])
    y1 = _fma_f32(r, p[3], p[4])
    y2 = _fma_f32(r, p[6], p[7])
    y0 = _fma_f32(y0, r, p[2])
    y1 = _fma_f32(y1, r, p[5])
    y2 = _fma_f32(y2, r, p[8])
    y = _fma_f32(y0, r3, y1)
    y = _fma_f32(y, r3, y2)
    y = _fma_f32(y, r3, e * _f32(_LOG_Q1, dev))
    out = ((r - r2 * 0.5) + y) + e * _f32(_LOG_Q2, dev)
    ok = (x > 0) & torch.isfinite(x)
    return torch.where(ok, out, torch.log(x))


def centered_prefix_sums(y_sorted: torch.Tensor):
    """``(cy, cyy, cxy)``: inclusive prefix sums over the last dimension of
    ``z = y - y[(n-1)//2]`` (an exact element pick, no reduction rounding),
    ``z^2`` and ``k * z`` with k = 1..n."""
    y = _promote(y_sorted)
    n = y.shape[-1]
    idx = torch.arange(1, n + 1, dtype=torch.float32, device=y.device)
    z = y - y[..., (n - 1) // 2:(n - 1) // 2 + 1]
    # One scan over the three stacked rows: the adds per element are the
    # same, in a third of the launches.
    return xla_order_cumsum(torch.stack([z, z * z, idx * z])).unbind(0)


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
