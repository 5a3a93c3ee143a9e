"""The change-point estimator in one kernel: wrappers and the plain twin.

The port of ``repro.kernels.changepoint`` (Pallas ``sse_scan``,
``kernel.py:78``, and the centring, ``jnp.cumsum`` and ``jnp.argmin`` that
the reference runs around it per row).  ``csrc/changepoint.cu`` takes sorted
values and returns ``t = argmin + 1`` per row, with the SSE landscape on
request: centring on the element ``(n-1)//2``, the three prefix sums in
``xla_order_cumsum``'s add order, the f64 index closed forms rounded once to
f32, both segment SSEs, the +inf mask and the argmin (lowest index on a
tie), all in one launch over a ragged batch of rows.

Entries:

- ``changepoint_ragged(values, starts, lengths, span=...)``: row ``r`` is
  ``values[starts[r]:starts[r] + lengths[r]]`` of one f32 arena (the
  anomaly monitor's rings, one launch per mux tick);
- ``changepoint_cuda(y)``: dense rows ``(..., n)`` (the engine's gather
  path), ``two_segment_sse_cuda(y)``: their landscape.

Each dispatches on where its tensors lie: CPU tensors take the plain twin
``changepoint_ragged_plain`` (``core.changepoint.two_segment_sse`` and
``argmin`` per group of equal-length rows), CUDA tensors launch the kernel
(or raise; nothing falls back).  ``LAUNCHES`` counts kernel launches.
``prefix_inputs`` and ``sse_scan_plain`` are the same computation split at
the prefix sums, the decomposition the tests hold the pieces to.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.changepoint import (centered_prefix_sums, closed_forms_f32,
                                 sse_from_prefix_sums, two_segment_sse)
from .. import runtime

__all__ = ["LAUNCHES", "SHARED_FLOATS", "changepoint_cuda",
           "changepoint_ragged", "changepoint_ragged_plain", "pack_rows",
           "scan_floats", "two_segment_sse_cuda"]

# Kernel launches issued on CUDA tensors (a plain counter: callers zero it
# and read it back to prove a path ran through the kernel).
LAUNCHES = 0

# The kernel's scan layout (csrc/changepoint.cu): per level of the blocked
# scan, three channels of 17 floats per 16-block; rows whose scans fit in
# SHARED_FLOATS run in shared memory, longer ones in global scratch.
_SCAN_BLOCK = 16
_SCAN_PAD = 17
SHARED_FLOATS = (232448 - 1024) // 4
# Blocks per SM on the global-scratch route (bounds the scratch it needs).
_SCRATCH_BLOCKS_PER_SM = 2


def scan_floats(n: int) -> int:
    """Floats the kernel's three XLA-order scans of an ``n``-element row
    take (``levels_of`` in the ``.cu``)."""
    total, m = 0, int(n)
    while True:
        nb = -(-m // _SCAN_BLOCK)
        total += 3 * _SCAN_PAD * nb
        if nb == 1:
            return total
        m = nb


# ------------------------------------------------------- plain decomposition
def prefix_inputs(y_sorted: torch.Tensor):
    """The scan's operands for sorted rows ``(rows, n)``: ``cy, cyy, cxy``
    (rows, n), ``totals`` (rows, 3) and the four (n,) closed forms."""
    y = torch.as_tensor(y_sorted).to(torch.float32)
    y = y.reshape(-1, y.shape[-1])
    cy, cyy, cxy = centered_prefix_sums(y)
    totals = torch.stack([cy[:, -1], cyy[:, -1], cxy[:, -1]], dim=-1)
    return cy, cyy, cxy, totals, closed_forms_f32(y.shape[-1], y.device)


def sse_scan_plain(cy, cyy, cxy, totals, forms, omega: int = 3):
    """``(sse (rows, n), t (rows,))`` from ``prefix_inputs``, with
    ``t = argmin + 1`` (int32, lowest index on ties, 1 on an all-inf row)."""
    sse = sse_from_prefix_sums(cy, cyy, cxy, totals, forms, omega)
    return sse, (torch.argmin(sse, dim=-1) + 1).to(torch.int32)


# ----------------------------------------------------------------- plain twin
def _dense_plain(y: torch.Tensor, omega: int):
    sse = two_segment_sse(y, omega=omega)
    return (torch.argmin(sse, dim=-1) + 1).to(torch.int32), sse


def changepoint_ragged_plain(values, starts, lengths, omega: int = 3,
                             landscape: bool = False):
    """Plain PyTorch version of the kernel over ragged rows.

    ``values``: (N,) f32 arena; ``starts``/``lengths``: (rows,) int.  Rows
    of one length run together through ``core.changepoint.two_segment_sse``
    and ``argmin`` (one set of ops per distinct length).  Returns ``(t,
    sse)``: ``t`` (rows,) int32 on ``values``' device; ``sse`` the landscape
    in the arena's layout (positions no row covers unwritten) or ``None``.
    """
    values = torch.as_tensor(values)
    dev = values.device
    st = torch.as_tensor(starts).to(torch.int64).cpu()
    ln = torch.as_tensor(lengths).to(torch.int64).cpu()
    t = torch.empty(ln.numel(), dtype=torch.int32, device=dev)
    sse = torch.empty_like(values) if landscape else None
    for n in torch.unique(ln).tolist():
        rows = torch.nonzero(ln == n).flatten()
        index = (st[rows, None] + torch.arange(n)).to(dev)
        t_g, sse_g = _dense_plain(values[index], omega)
        t[rows.to(dev)] = t_g
        if sse is not None:
            sse[index] = sse_g
    return t, sse


# --------------------------------------------------------------------- kernel
def _check(name: str, x: torch.Tensor, dtype, device) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _require_split(n: int, omega: int, who: str) -> None:
    if n < 2 * omega:
        raise ValueError(
            f"{who} needs n >= 2*omega points to probe a split "
            f"(omega={omega} on each side), got n={n}")


def _device_of(x: torch.Tensor, who: str) -> torch.device:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who} runs on cpu or cuda tensors, got {x.device}")
    return x.device


def _launch(values, starts, lengths, rows: int, lmax: int, omega: int,
            landscape: bool):
    """One kernel launch on the current stream (no synchronisation).
    ``starts is None``: dense rows of ``lmax``."""
    dev = values.device
    _check("values", values, torch.float32, dev)
    if starts is not None:
        _check("starts", starts, torch.int32, dev)
        _check("lengths", lengths, torch.int32, dev)
    t = torch.empty(rows, dtype=torch.int32, device=dev)
    sse = torch.empty_like(values) if landscape else None
    floats = scan_floats(lmax)
    scratch, blocks = None, 0
    if floats > SHARED_FLOATS:  # long rows: the same scans in global scratch
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks = min(rows, _SCRATCH_BLOCKS_PER_SM * sms)
        scratch = torch.empty(blocks * floats, dtype=torch.float32,
                              device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    lib = runtime.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.changepoint_scan(
            values.data_ptr(), ptr(starts), ptr(lengths), rows,
            lmax if starts is None else 0, lmax, int(omega), ptr(sse),
            t.data_ptr(), ptr(scratch), blocks, floats, stream)
    runtime.check(code, "changepoint_scan")
    global LAUNCHES
    LAUNCHES += 1
    return t, sse


def changepoint_ragged(values, starts, lengths, omega: int = 3, *, span,
                       landscape: bool = False):
    """``t`` per ragged row (and the landscape on request) in one launch.

    ``values``: (N,) f32 arena of sorted rows; ``starts``/``lengths``:
    (rows,) int32 on the same device; ``span``: the ``(shortest, longest)``
    row length, as ``pack_rows`` returns it (the kernel sizes its scans by
    ``longest``).  Returns ``(t, sse)`` like ``changepoint_ragged_plain``.
    CPU tensors run the plain twin; CUDA tensors launch the kernel on the
    current stream without synchronising.

    Raises:
        ValueError: a row shorter than ``2*omega`` (no valid split), or
            tensors on a device other than cpu or cuda.
    """
    dev = _device_of(values, "changepoint_ragged")
    _require_split(int(span[0]), omega, "changepoint_ragged")
    if dev.type == "cpu":
        return changepoint_ragged_plain(values, starts, lengths, omega,
                                        landscape)
    return _launch(values, starts, lengths, int(lengths.numel()),
                   int(span[1]), omega, landscape)


def _dense(y_sorted, omega: int, landscape: bool, who: str):
    y = torch.as_tensor(y_sorted).to(torch.float32)
    dev = _device_of(y, who)
    n = y.shape[-1]
    if n == 0:
        raise ValueError(f"{who} needs at least one point per row")
    flat = y.reshape(-1, n)
    if dev.type == "cpu":
        t, sse = _dense_plain(flat, omega)
    else:
        flat = flat.contiguous()
        t, sse = _launch(flat, None, None, flat.shape[0], n, omega,
                         landscape)
    return t.reshape(y.shape[:-1]), (sse.reshape(y.shape) if landscape
                                     else None)


def two_segment_sse_cuda(y_sorted, omega: int = 3) -> torch.Tensor:
    """SSE landscape of sorted rows ``(..., n)``, from the kernel on CUDA
    tensors (+inf outside ``[omega, n - omega]``)."""
    return _dense(y_sorted, omega, True, "two_segment_sse_cuda")[1]


def changepoint_cuda(y_sorted, omega: int = 3) -> torch.Tensor:
    """t-hat per row (int32, 1-indexed prefix size) of sorted rows
    ``(..., n)``, matching ``core.estimate_changepoint``.

    Raises:
        ValueError: ``n < 2*omega`` — no valid split exists.
    """
    y = torch.as_tensor(y_sorted)
    _require_split(y.shape[-1], omega, "changepoint_cuda")
    return _dense(y, omega, False, "changepoint_cuda")[0]


def pack_rows(groups, device) -> tuple:
    """Rows of several lengths in one host buffer, copied to ``device`` at
    once: ``groups`` is a list of 2-D arrays, each holding rows of one
    length.  The buffer holds the f32 rows end to end, then their int32
    starts and lengths.  Returns ``((values, starts, lengths), (shortest,
    longest))``, the first three views of the one device buffer."""
    lengths = np.repeat([g.shape[1] for g in groups],
                        [g.shape[0] for g in groups]).astype(np.int32)
    rows, total = lengths.size, int(lengths.sum())
    buf = np.empty(total + 2 * rows, np.int32)
    buf[:total] = np.concatenate(
        [np.asarray(g, np.float32).ravel() for g in groups]).view(np.int32)
    buf[total:total + rows] = np.cumsum(lengths) - lengths
    buf[total + rows:] = lengths
    dev_buf = torch.from_numpy(buf).to(device)
    return ((dev_buf[:total].view(torch.float32),
             dev_buf[total:total + rows], dev_buf[total + rows:]),
            (int(lengths.min()), int(lengths.max())))
