"""Batched change-point SSE scan: the CUDA kernel, its plain twin, wrappers.

The port of ``repro.kernels.changepoint`` (Pallas ``sse_scan``,
``kernel.py:78``).  The reference launches the scan per row under ``vmap``
and takes the argmin on the host; here one launch covers a whole
``(rows, n)`` batch and fuses the argmin (lowest index wins, as
``jnp.argmin``).

``prefix_inputs`` builds the kernel inputs exactly as the plain scan does —
midpoint-element centering, ``xla_order_cumsum`` prefix sums (outside the
kernel, as ``jnp.cumsum`` is outside the Pallas body) and the f64 index
closed forms rounded once to f32 — so kernel and plain version see the same
operands.  ``sse_scan`` dispatches on where its tensors lie: CPU tensors take
``sse_scan_plain``, CUDA tensors launch ``csrc/changepoint.cu`` (or raise;
nothing falls back).  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from ...core.changepoint import (centered_prefix_sums, closed_forms_f32,
                                 sse_from_prefix_sums)
from .. import runtime

__all__ = ["LAUNCHES", "changepoint_cuda", "prefix_inputs", "sse_scan",
           "sse_scan_plain", "two_segment_sse_cuda"]

# Kernel launches issued by ``sse_scan`` on CUDA tensors (a plain counter:
# callers zero it and read it back to prove a path ran through the kernel).
LAUNCHES = 0


def prefix_inputs(y_sorted: torch.Tensor):
    """Kernel operands for sorted rows ``(rows, n)``: ``cy, cyy, cxy``
    (rows, n), ``totals`` (rows, 3) and the four (n,) closed forms."""
    y = torch.as_tensor(y_sorted).to(torch.float32)
    y = y.reshape(-1, y.shape[-1])
    cy, cyy, cxy = centered_prefix_sums(y)
    totals = torch.stack([cy[:, -1], cyy[:, -1], cxy[:, -1]], dim=-1)
    return cy, cyy, cxy, totals, closed_forms_f32(y.shape[-1], y.device)


def sse_scan_plain(cy, cyy, cxy, totals, forms, omega: int = 3):
    """Plain PyTorch version of the kernel: ``(sse (rows, n), t (rows,))``
    with ``t = argmin + 1`` (int32, lowest index on ties, 1 on an all-inf
    row)."""
    sse = sse_from_prefix_sums(cy, cyy, cxy, totals, forms, omega)
    return sse, (torch.argmin(sse, dim=-1) + 1).to(torch.int32)


def _check(name: str, x: torch.Tensor, shape, device) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sse_scan(cy, cyy, cxy, totals, forms, omega: int = 3):
    """SSE landscape and fused argmin for a batch of prefix sums.

    ``cy``/``cyy``/``cxy``: (rows, n) f32; ``totals``: (rows, 3) f32;
    ``forms``: four (n,) f32.  Returns ``(sse, t)`` like ``sse_scan_plain``.
    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream without synchronising.
    """
    if cy.device.type == "cpu":
        return sse_scan_plain(cy, cyy, cxy, totals, forms, omega)
    if cy.device.type != "cuda":
        raise ValueError(f"sse_scan runs on cpu or cuda tensors, "
                         f"got {cy.device}")
    rows, n = cy.shape
    for name, x in (("cy", cy), ("cyy", cyy), ("cxy", cxy)):
        _check(name, x, (rows, n), cy.device)
    _check("totals", totals, (rows, 3), cy.device)
    for name, x in zip(("sx1", "sxx1", "sx2", "sxx2"), forms):
        _check(name, x, (n,), cy.device)
    sse = torch.empty((rows, n), dtype=torch.float32, device=cy.device)
    t = torch.empty(rows, dtype=torch.int32, device=cy.device)
    lib = runtime.load_library()
    with torch.cuda.device(cy.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.changepoint_sse_argmin(
            cy.data_ptr(), cyy.data_ptr(), cxy.data_ptr(), totals.data_ptr(),
            *(f.data_ptr() for f in forms), sse.data_ptr(), t.data_ptr(),
            rows, n, int(omega), stream)
    runtime.check(code, "changepoint_sse_argmin")
    global LAUNCHES
    LAUNCHES += 1
    return sse, t


def _require_split(n: int, omega: int, who: str) -> None:
    if n < 2 * omega:
        raise ValueError(
            f"{who} needs n >= 2*omega points to probe a split "
            f"(omega={omega} on each side), got n={n}")


def two_segment_sse_cuda(y_sorted, omega: int = 3) -> torch.Tensor:
    """SSE landscape of sorted rows ``(..., n)`` through ``sse_scan``."""
    y = torch.as_tensor(y_sorted).to(torch.float32)
    sse, _ = sse_scan(*prefix_inputs(y), omega=omega)
    return sse.reshape(y.shape)


def changepoint_cuda(y_sorted, omega: int = 3) -> torch.Tensor:
    """t-hat per row (int32, 1-indexed prefix size) through ``sse_scan``,
    matching ``core.estimate_changepoint``.

    Raises:
        ValueError: ``n < 2*omega`` — no valid split exists.
    """
    y = torch.as_tensor(y_sorted).to(torch.float32)
    _require_split(y.shape[-1], omega, "changepoint_cuda")
    _, t = sse_scan(*prefix_inputs(y), omega=omega)
    return t.reshape(y.shape[:-1])
