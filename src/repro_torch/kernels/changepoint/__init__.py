"""The change-point estimator in one kernel, from sorted values to t over
ragged rows (CUDA kernel ``csrc/changepoint.cu`` with its plain PyTorch
twin)."""

from .ops import (changepoint_cuda, changepoint_ragged,
                  changepoint_ragged_plain, pack_rows, two_segment_sse_cuda)
from .ref import changepoint_ref, two_segment_sse_ref

__all__ = ["changepoint_cuda", "changepoint_ragged",
           "changepoint_ragged_plain", "changepoint_ref", "pack_rows",
           "two_segment_sse_cuda", "two_segment_sse_ref"]
