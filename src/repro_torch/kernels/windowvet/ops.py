"""Fused window vet: ragged windows of one arena -> (vet, ei, oc, pr, t, n).

The port of ``repro.kernels.windowvet`` (Pallas ``fused_window_vet_scan``,
``kernel.py:226``).  One launch vets every row ``arena[starts[r] :
starts[r] + lengths[r])`` through the whole pipeline — exact sort with +inf
padding, log, midpoint-element centering, three prefix sums, two-segment
SSE, lowest-index argmin, capped linear extrapolation, EI/OC — and writes
the lanes ``[vet, ei, oc, pr, t, n, 0, 0]``.

Three layers, as in the reference:

- ``fused_window_vet`` — the host wrapper the engine calls (numpy in,
  numpy out).  It computes PR for every window from one f64 prefix sum over
  the arena, pads rows to a power of two (>= ``BLOCK_ROWS``) by repeating
  the last row, sets ``lmax = max(8, pow2(longest window))``, pads the arena
  to ``pow2(arena + lmax)``, launches once, and finishes ``vet = pr64/ei``
  in f64.  Windows longer than ``MAX_LMAX`` are refused (the kernel's
  block path holds a row in 512 threads, 8 values each).
- ``fused_window_vet_scan`` — the tensor-level dispatch: CPU tensors run
  ``fused_window_vet_plain``, CUDA tensors launch ``csrc/windowvet.cu`` on
  the current stream (or raise; nothing falls back).  ``LAUNCHES`` counts
  kernel launches.
- ``fused_window_vet_plain`` — the batched plain PyTorch version (gather,
  ``torch.sort``, masked reductions; no per-row loop).  It repeats the
  kernel's arithmetic: the log is ``xla_order_log``, the prefix sums add in
  ``xla_order_cumsum``'s order, and EI/OC are pairwise trees
  (``_tree_sum``), so on the same device the kernel's lanes are its lanes.
  Every step depends only on the row's own values, never on the padded
  width ``lmax``: a row vets the same alone or in a launch padded to
  ``MAX_LMAX``.

As in the reference kernel, the index sums ``sx1``/``sxx1`` are evaluated
in f32 with the reference's expression order (``kernel.py:191-194``), not
from the f64 closed forms the gather path uses.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.changepoint import (segment_sse_terms, xla_order_cumsum,
                                 xla_order_log)
from .. import runtime

__all__ = ["BLOCK_ROWS", "LANES", "LAUNCHES", "MAX_LMAX", "WARP_MAX_LMAX",
           "fused_window_vet", "fused_window_vet_plain",
           "fused_window_vet_scan", "kernel_path", "launch_inputs",
           "sorted_scans", "staged_bytes"]

BLOCK_ROWS = 8  # rows pad to a power of two at least this large
LANES = 8  # output lanes per row: [vet, ei, oc, pr, t, n, 0, 0]
MAX_LMAX = 4096  # longest padded window the CUDA kernel takes
WARP_MAX_LMAX = 512  # widest launch of the kernel's warp path (windowvet.cu)
_TINY = 1e-12  # log-space floor, as core.vet._TINY

# Kernel launches issued by ``fused_window_vet_scan`` on CUDA tensors.
LAUNCHES = 0


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def staged_bytes(arena_len: int, rows: int, max_len: int) -> int:
    """Bytes one fused launch stages, by the reference's ledger formula: the
    padded f32 arena plus four per-row metadata vectors.  Kept unchanged so
    the engines' ``dispatch_bytes`` counters equal the reference's (the
    port's launch stages three of those vectors; it has no use for the sum
    of squares)."""
    lmax = max(8, _pow2(int(max_len)))
    rows_p = max(BLOCK_ROWS, _pow2(int(rows)))
    return 4 * _pow2(int(arena_len) + lmax) + 4 * 4 * rows_p


def kernel_path(lmax: int) -> str:
    """The kernel's path for a launch of width ``lmax``: ``"warp"`` (one
    warp per row, the row in registers) up to ``WARP_MAX_LMAX``, else
    ``"block"`` (one block per row)."""
    return "warp" if lmax <= WARP_MAX_LMAX else "block"


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension (a power of two) as a balanced pairwise
    tree: neighbours first, then pairs of pairs.  The zeros past a row's
    end only add to zero or to the row's own total, so the sum is the same
    at any padded width; the kernel adds in this order."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def sorted_scans(arena, starts, lengths, *, lmax: int,
                 log_space: bool = True):
    """The plain version up to its prefix sums, batched over rows.

    Returns ``(mask, y, z, cy, cyy, cxy)``, each (rows, lmax): the valid
    positions, the sorted row (+inf past n), its log (``xla_order_log`` of
    ``max(y, 1e-12)``; y itself when not ``log_space``), and the inclusive
    prefix sums (``xla_order_cumsum``) of ``zm = z - z[(n-1)//2]``,
    ``zm^2`` and ``k * zm`` (zero past n).
    """
    iota = torch.arange(lmax, device=arena.device)
    n = lengths.to(torch.int64)[:, None]
    mask = iota < n
    y = arena[starts.to(torch.int64)[:, None] + iota]
    y = torch.sort(torch.where(mask, y, torch.inf), dim=-1).values
    z = xla_order_log(torch.clamp(y, min=_TINY)) if log_space else y
    pivot = torch.gather(torch.where(mask, z, 0.0), 1, (n - 1) // 2)
    zm = torch.where(mask, z - pivot, 0.0)
    kf = (iota + 1).to(torch.float32)
    cy, cyy, cxy = xla_order_cumsum(torch.stack([zm, zm * zm, kf * zm]))
    return mask, y, z, cy, cyy, cxy


def fused_window_vet_plain(arena, starts, lengths, pr, *, lmax: int,
                           omega: int = 3, log_space: bool = True):
    """Plain PyTorch version of the kernel, batched over rows.

    ``arena``: (alen,) f32 with ``alen >= max(starts) + lmax``;
    ``starts``/``lengths``: (rows,) int32; ``pr``: (rows,) f32.
    Returns (rows, LANES) f32.
    """
    dev = arena.device
    mask, y, _, cy, cyy, cxy = sorted_scans(arena, starts, lengths,
                                            lmax=lmax, log_space=log_space)
    n = lengths.to(torch.int64)[:, None]
    kf = torch.arange(1, lmax + 1, device=dev, dtype=torch.float32)
    tot_y, tot_yy, tot_xy = (torch.gather(c, 1, n - 1) for c in (cy, cyy, cxy))

    nf = n.to(torch.float32)
    # A tensor divisor: on CUDA, dividing by a Python scalar multiplies by
    # its rounded reciprocal, which is not the kernel's IEEE division.
    six = torch.full((), 6.0, device=dev)
    sx1 = kf * (kf + 1.0) * 0.5
    sxx1 = kf * (kf + 1.0) * (2.0 * kf + 1.0) / six
    sx_tot = nf * (nf + 1.0) * 0.5
    sxx_tot = nf * (nf + 1.0) * (2.0 * nf + 1.0) / six
    sse1 = segment_sse_terms(kf, sx1, cy, sxx1, cxy, cyy)
    sse2 = segment_sse_terms(nf - kf, sx_tot - sx1, tot_y - cy,
                             sxx_tot - sxx1, tot_xy - cxy, tot_yy - cyy)
    valid = (kf >= omega) & (kf <= nf - omega) & mask
    sse = torch.where(valid, sse1 + sse2, torch.inf)
    tb = torch.argmin(sse, dim=1, keepdim=True) + 1  # 1-indexed

    i = torch.clamp(tb - 1, min=torch.ones_like(n), max=n - 1)
    anchor = torch.gather(y, 1, i)
    slope = torch.clamp(anchor - torch.gather(y, 1, i - 1), min=0.0)
    rank = torch.arange(1, lmax + 1, device=dev)
    prefix = rank <= tb
    g = torch.minimum(anchor + slope * (rank - tb).to(torch.float32), y)
    ei = _tree_sum(torch.where(mask, torch.where(prefix, y, g), 0.0))
    oc = _tree_sum(torch.where(mask, torch.where(prefix, 0.0, y - g), 0.0))
    zero = torch.zeros_like(ei)
    return torch.stack([pr / ei, ei, oc, pr, tb[:, 0].to(torch.float32),
                        nf[:, 0], zero, zero], dim=1)


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_window_vet_scan(arena, starts, lengths, pr, *, lmax: int,
                          omega: int = 3, log_space: bool = True):
    """One fused launch over a padded ragged window set.

    Same contract as ``fused_window_vet_plain``; ``lmax`` must be a power of
    two in ``[8, MAX_LMAX]`` covering every length.  CPU tensors run the
    plain version; CUDA tensors launch the kernel without synchronising, on
    its warp path up to ``WARP_MAX_LMAX`` and its block path above
    (``kernel_path``).
    """
    if arena.device.type == "cpu":
        return fused_window_vet_plain(arena, starts, lengths, pr, lmax=lmax,
                                      omega=omega, log_space=log_space)
    if arena.device.type != "cuda":
        raise ValueError(f"fused_window_vet_scan runs on cpu or cuda "
                         f"tensors, got {arena.device}")
    if lmax < 8 or lmax > MAX_LMAX or lmax & (lmax - 1):
        raise ValueError(f"lmax must be a power of two in [8, {MAX_LMAX}], "
                         f"got {lmax}")
    rows = starts.shape[0]
    dev = arena.device
    _check("arena", arena, torch.float32, (arena.shape[0],), dev)
    _check("starts", starts, torch.int32, (rows,), dev)
    _check("lengths", lengths, torch.int32, (rows,), dev)
    _check("pr", pr, torch.float32, (rows,), dev)
    out = torch.empty((rows, LANES), dtype=torch.float32, device=dev)
    lib = runtime.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.windowvet_fused(
            arena.data_ptr(), starts.data_ptr(), lengths.data_ptr(),
            pr.data_ptr(), out.data_ptr(), rows, int(lmax), int(omega),
            int(bool(log_space)), stream)
    runtime.check(code, "windowvet_fused")
    global LAUNCHES
    LAUNCHES += 1
    return out


def launch_inputs(arena, starts, lengths, device):
    """Validate a ragged window set and build the padded launch operands.

    Returns ``(operands, lmax, pr64, lengths)``: ``operands`` is the
    ``(arena, starts, lengths, pr)`` tensor tuple on ``device`` for
    ``fused_window_vet_scan``; ``pr64`` the f64 window sums; ``lengths``
    the int64 host lengths (unpadded).
    """
    a64 = np.asarray(arena, dtype=np.float64).ravel()
    starts = np.asarray(starts, dtype=np.int64).ravel()
    lengths = np.asarray(lengths, dtype=np.int64).ravel()
    rows = starts.size
    if rows == 0:
        raise ValueError("fused_window_vet needs at least one window")
    if rows != lengths.size:
        raise ValueError(f"starts ({rows}) and lengths ({lengths.size}) "
                         f"disagree")
    if lengths.min() < 2:
        raise ValueError("every window must cover >= 2 records")
    if lengths.max() > MAX_LMAX:
        raise ValueError(f"windows longer than {MAX_LMAX} records do not fit "
                         f"the fused kernel (got {int(lengths.max())})")
    if starts.min() < 0 or (starts + lengths).max() > a64.size:
        raise ValueError("window out of arena bounds")

    # PR for every window from one f64 prefix sum over the arena.
    ps = np.concatenate([[0.0], np.cumsum(a64)])
    pr64 = ps[starts + lengths] - ps[starts]

    lmax = max(8, _pow2(int(lengths.max())))
    pad = max(BLOCK_ROWS, _pow2(rows)) - rows
    starts_p = np.concatenate([starts, np.repeat(starts[-1:], pad)])
    lengths_p = np.concatenate([lengths, np.repeat(lengths[-1:], pad)])
    pr_p = np.concatenate([pr64, np.repeat(pr64[-1:], pad)])
    arena_f32 = np.zeros(_pow2(a64.size + lmax), dtype=np.float32)
    arena_f32[:a64.size] = a64
    tensors = (torch.from_numpy(arena_f32).to(device),
               torch.from_numpy(starts_p.astype(np.int32)).to(device),
               torch.from_numpy(lengths_p.astype(np.int32)).to(device),
               torch.from_numpy(pr_p.astype(np.float32)).to(device))
    return tensors, lmax, pr64, lengths


def fused_window_vet(arena, starts, lengths, *, omega: int = 3,
                     cut_space: str = "log", device=None,
                     plain: bool = False):
    """Vet every window ``arena[starts[r] : starts[r] + lengths[r])`` fused.

    Args:
        arena: 1-D record-time buffer the windows index into.
        starts: (rows,) window start offsets into ``arena``.
        lengths: (rows,) window lengths (each in ``[2, MAX_LMAX]``).
        omega / cut_space: estimator parameters (the non-bucketed
            ``vet_task`` estimator; the engine keeps bucketed rows on the
            gather path).
        device: where the launch runs (``None``: the device policy of
            ``kernels.runtime``).
        plain: run ``fused_window_vet_plain`` on ``device`` instead of the
            kernel (the engine's ``torch`` backend).

    Returns:
        ``(vet, ei, oc, pr, t, n)`` host arrays, one entry per input row.
    """
    dev = runtime.require_device(runtime.resolve_device(device))
    tensors, lmax, pr64, lengths = launch_inputs(arena, starts, lengths, dev)
    scan = fused_window_vet_plain if plain else fused_window_vet_scan
    out = scan(*tensors, lmax=lmax, omega=omega,
               log_space=(cut_space == "log"))
    out = out[:lengths.size].cpu().numpy()
    ei = out[:, 1].astype(np.float64)
    oc = out[:, 2].astype(np.float64)
    # PR (and vet's numerator) from the f64 prefix sums.
    return (pr64 / ei, ei, oc, pr64, out[:, 4].astype(np.int32),
            lengths.astype(np.int64))
