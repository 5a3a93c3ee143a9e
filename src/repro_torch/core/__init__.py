"""The paper's contribution: the vet optimality measure, in PyTorch.

Pipeline:  record times -> order statistics -> LSE change-point ->
monotone extrapolation g-hat -> (EI, OC) -> vet_task -> vet_job.

The port of ``repro.core``, with the paper's evaluation around the measure:
``stats`` (KS test, Pearson correlation, the 1000-bucket view), ``tail``
(Hill estimator and plot, emplot) and ``online`` (the EMA estimator over a
``VetStream``).
"""

from .online import OnlineVet, OnlineVetSnapshot
from .changepoint import (
    estimate_changepoint,
    estimate_changepoint_naive,
    two_segment_sse,
)
from .extrapolate import ghat_curve, local_slope
from .stats import KSResult, bucketize, ks_2samp, pearson
from .tail import TailReport, emplot, hill_estimator, hill_plot, tail_report
from .vet import VetJobResult, VetResult, ei_oc, vet_job, vet_pipeline, vet_task

__all__ = [
    "OnlineVet",
    "OnlineVetSnapshot",
    "estimate_changepoint",
    "estimate_changepoint_naive",
    "two_segment_sse",
    "ghat_curve",
    "local_slope",
    "KSResult",
    "bucketize",
    "ks_2samp",
    "pearson",
    "TailReport",
    "emplot",
    "hill_estimator",
    "hill_plot",
    "tail_report",
    "VetJobResult",
    "VetResult",
    "ei_oc",
    "vet_job",
    "vet_pipeline",
    "vet_task",
]
