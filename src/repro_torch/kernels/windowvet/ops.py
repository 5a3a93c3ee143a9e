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
  in f64.  Windows longer than ``MAX_LMAX`` are refused (the kernel keeps a
  sorted row and three scans of ``lmax`` floats in shared memory).
- ``fused_window_vet_scan`` — the tensor-level dispatch: CPU tensors run
  ``fused_window_vet_plain``, CUDA tensors launch ``csrc/windowvet.cu`` on
  the current stream (or raise; nothing falls back).  ``LAUNCHES`` counts
  kernel launches.
- ``fused_window_vet_plain`` — the batched plain PyTorch version (gather,
  ``torch.sort``, masked reductions; no per-row loop).  It repeats the
  kernel's arithmetic: its prefix sums (``block_scan``) add in the kernel's
  order, so on the same device the two pick the same cut.

As in the reference kernel, the index sums ``sx1``/``sxx1`` are evaluated
in f32 with the reference's expression order (``kernel.py:191-194``), not
from the f64 closed forms the gather path uses.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.changepoint import segment_sse_terms
from .. import runtime

__all__ = ["BLOCK_ROWS", "LANES", "LAUNCHES", "MAX_LMAX", "block_scan",
           "fused_window_vet",
           "fused_window_vet_plain", "fused_window_vet_scan", "launch_inputs",
           "staged_bytes"]

BLOCK_ROWS = 8  # rows pad to a power of two at least this large
LANES = 8  # output lanes per row: [vet, ei, oc, pr, t, n, 0, 0]
MAX_LMAX = 4096  # longest padded window the CUDA kernel takes
MAX_THREADS = 1024  # threads per block of the kernel (windowvet.cu)
_WARP = 32
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


def _warp_scan(v: torch.Tensor) -> torch.Tensor:
    """Inclusive scan over the last dimension (32 lanes) in the order of a
    ``__shfl_up_sync`` ladder: lane ``l`` adds lane ``l - d`` for
    d = 1, 2, 4, 8, 16."""
    lane = torch.arange(_WARP, device=v.device)
    d = 1
    while d < _WARP:
        v = torch.where(lane >= d, v + F.pad(v[..., :-d], (d, 0)), v)
        d *= 2
    return v


def block_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last dimension of ``x`` (rows, lmax),
    adding in the order of the kernel's block scan: each of
    ``max(32, min(MAX_THREADS, lmax))`` threads sums a contiguous chunk
    serially, a warp ladder scans the chunk totals, one warp scans the warp
    totals, and every element gets its offsets added last."""
    rows, lmax = x.shape
    nt = max(_WARP, min(MAX_THREADS, lmax))
    chunk = max(1, lmax // nt)
    cols = x.reshape(rows, -1, chunk) if lmax >= nt else \
        F.pad(x, (0, nt - lmax)).reshape(rows, nt, 1)
    acc = torch.zeros_like(cols[:, :, 0])
    local = []
    for j in range(chunk):
        acc = acc + cols[:, :, j]
        local.append(acc)
    local = torch.stack(local, dim=-1)  # (rows, nt, chunk)
    nw = nt // _WARP
    inc = _warp_scan(acc.reshape(rows, nw, _WARP))
    excl = F.pad(inc[..., :-1], (1, 0))  # lane 0 starts at 0
    warp_inc = _warp_scan(F.pad(inc[..., -1], (0, _WARP - nw)))
    warp_excl = F.pad(warp_inc[..., :-1], (1, 0))[:, :nw, None]
    first = torch.arange(nw, device=x.device)[:, None] == 0
    ex = torch.where(first, excl, warp_excl + excl).reshape(rows, nt, 1)
    return (local + ex).reshape(rows, -1)[:, :lmax]


def fused_window_vet_plain(arena, starts, lengths, pr, *, lmax: int,
                           omega: int = 3, log_space: bool = True):
    """Plain PyTorch version of the kernel, batched over rows.

    ``arena``: (alen,) f32 with ``alen >= max(starts) + lmax``;
    ``starts``/``lengths``: (rows,) int32; ``pr``: (rows,) f32.
    Returns (rows, LANES) f32.
    """
    dev = arena.device
    iota = torch.arange(lmax, device=dev)
    n = lengths.to(torch.int64)[:, None]
    mask = iota < n
    y = arena[starts.to(torch.int64)[:, None] + iota]
    y = torch.sort(torch.where(mask, y, torch.inf), dim=-1).values
    z = torch.log(torch.clamp(y, min=_TINY)) if log_space else y
    pivot = torch.gather(torch.where(mask, z, 0.0), 1, (n - 1) // 2)
    zm = torch.where(mask, z - pivot, 0.0)
    kf = (iota + 1).to(torch.float32)
    cy = block_scan(zm)
    cyy = block_scan(zm * zm)
    cxy = block_scan(kf * zm)
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
    rank = iota + 1
    prefix = rank <= tb
    g = torch.minimum(anchor + slope * (rank - tb).to(torch.float32), y)
    ei = torch.where(mask, torch.where(prefix, y, g), 0.0).sum(dim=1)
    oc = torch.where(mask, torch.where(prefix, 0.0, y - g), 0.0).sum(dim=1)
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
    plain version; CUDA tensors launch the kernel without synchronising.
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
