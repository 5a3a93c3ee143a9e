"""The benchmark's fixed arithmetic: the card's peaks, the operations and
bytes of a flash-attention launch, the bound of a prefill's launches and
its operations (counted by the configuration's family), and the
reduction of a profiler trace to busy time and idle gaps.

The peaks and the flash counts are frozen copies of what ``chip_smoke.py``
uses (its ``HBM_BYTES_PER_S``, ``TF32X3_OPS_PER_S`` and ``flash_cases``),
so a later change to the smoke moves nothing here.  Published peaks of one
NVIDIA H100 SXM (dense, 700 W): 3.35 TB/s of HBM3; TF32 on the tensor
cores 495 TFLOP/s, so an f32-accurate product there (three TF32 passes)
at best 165 TFLOP/s, the least time an f32 product can take on the card.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

from . import families

__all__ = ["F32_PEAK_OPS", "HBM_BYTES_PER_S", "busy_intervals",
           "flash_bound_s", "flash_cost", "idle_gaps", "live_pairs",
           "prefill_flops", "roofline_s"]

HBM_BYTES_PER_S = 3.35e12
TF32_OPS_PER_S = 495e12
F32_PEAK_OPS = TF32_OPS_PER_S / 3  # 3xTF32: the f32-accurate peak


def roofline_s(ops: float, nbytes: float) -> float:
    """The least time the card can take for f32 work: the larger of
    operations over the f32-accurate peak and bytes over the memory
    bandwidth."""
    return max(ops / F32_PEAK_OPS, nbytes / HBM_BYTES_PER_S)


def live_pairs(s: int, causal: bool = True) -> int:
    """Unmasked (query, key) pairs of one (batch, head) without a window."""
    return s * (s + 1) // 2 if causal else s * s


def flash_cost(b: int, s: int, h: int, kh: int, d: int, dv: int,
               elem_bytes: int = 4, causal: bool = True) -> Tuple[float, float]:
    """(operations, bytes) of one flash-attention launch: 2 (D + Dv) a live
    pair and head; Q and K read at D, V read and O written at Dv, once
    each."""
    ops = 2.0 * (d + dv) * live_pairs(s, causal) * b * h
    nbytes = elem_bytes * (b * s * h * (d + dv) + b * s * kh * (d + dv))
    return ops, nbytes


def flash_bound_s(c: dict, b: int, s: int) -> float:
    """The summed bound of one prefill's flash launches (its family's
    ``flash_launches``) for configuration file ``c`` at batch ``b`` and
    prompt ``s``.  ``fsum`` rounds once, so n equal launches give exactly
    n times one."""
    return math.fsum(
        roofline_s(*flash_cost(lb, ls, h, kh, d, dv, causal=causal))
        for lb, ls, h, kh, d, dv, causal
        in families.of(c).flash_launches(c, b, s))


def prefill_flops(c: dict, b: int, s: int) -> float:
    """Operations of the published model's prefill of ``b`` prompts of
    ``s`` tokens, as its family counts them (``families``)."""
    return families.of(c).prefill_flops(c, b, s)


def busy_intervals(events: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals, merged and sorted."""
    out: List[List[int]] = []
    for s, e in sorted(events):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_gaps(busy: Sequence[Tuple[int, int]], lo: int,
              hi: int) -> List[Tuple[int, int]]:
    """The gaps of [lo, hi) that ``busy`` (merged, sorted) leaves."""
    gaps, at = [], lo
    for s, e in busy:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps
