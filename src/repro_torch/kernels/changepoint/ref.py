"""Plain oracle for the two-segment SSE scan (paper §4.3): the port's
``core.changepoint`` prefix-sum formulation, which the kernel must match
(same centering, closed forms and masking)."""

from __future__ import annotations

import torch

from ...core.changepoint import two_segment_sse

__all__ = ["changepoint_ref", "two_segment_sse_ref"]


def two_segment_sse_ref(y_sorted, omega: int = 3) -> torch.Tensor:
    return two_segment_sse(y_sorted, omega=omega)


def changepoint_ref(y_sorted, omega: int = 3) -> torch.Tensor:
    sse = two_segment_sse_ref(y_sorted, omega=omega)
    return (torch.argmin(sse, dim=-1) + 1).to(torch.int32)
