"""Batched change-point SSE scan (CUDA kernel ``csrc/changepoint.cu`` with
its plain PyTorch twin)."""

from .ops import changepoint_cuda, sse_scan, sse_scan_plain, two_segment_sse_cuda
from .ref import changepoint_ref, two_segment_sse_ref

__all__ = ["changepoint_cuda", "changepoint_ref", "sse_scan",
           "sse_scan_plain", "two_segment_sse_cuda", "two_segment_sse_ref"]
