"""The paper's contribution: the vet optimality measure, in PyTorch.

Pipeline:  record times -> order statistics -> LSE change-point ->
monotone extrapolation g-hat -> (EI, OC) -> vet_task -> vet_job.

The port of ``repro.core``; ``online``, ``stats`` and ``tail`` are not
ported yet.
"""

from .changepoint import (
    estimate_changepoint,
    estimate_changepoint_naive,
    two_segment_sse,
)
from .extrapolate import ghat_curve, local_slope
from .vet import VetJobResult, VetResult, ei_oc, vet_job, vet_pipeline, vet_task

__all__ = [
    "estimate_changepoint",
    "estimate_changepoint_naive",
    "two_segment_sse",
    "ghat_curve",
    "local_slope",
    "VetJobResult",
    "VetResult",
    "ei_oc",
    "vet_job",
    "vet_pipeline",
    "vet_task",
]
