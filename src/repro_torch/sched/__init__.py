"""repro_torch.sched — vet-driven scheduling and the online vet tuner.

The port of ``repro.sched``: ``straggler`` (``VetController``, the paper's
§5.5 W-rule and KS-confirmed straggler flags over one fleet mux) and
``tuner`` (``VetTuner``, its SPSA and bandit pieces, the grid oracle and
the scenario harnesses), and ``autotune`` (``tune``, the offline grid over
``n_micro`` x ``q_chunk`` of the training step, each candidate audited by
vet).
"""

from .autotune import tune
from .straggler import SchedulerDecision, VetController
from .tuner import (
    ElbowResult,
    FrontierPoint,
    GridResult,
    SPSAConfig,
    TuneCandidate,
    TuneReport,
    VetTuner,
    elbow_walk,
    evaluate_candidate,
    grid_scenario,
    grid_search,
    objective_from_tick,
    spsa_gradient,
    tune_scenario,
)

__all__ = [
    "ElbowResult",
    "FrontierPoint",
    "GridResult",
    "SPSAConfig",
    "SchedulerDecision",
    "TuneCandidate",
    "TuneReport",
    "VetController",
    "VetTuner",
    "elbow_walk",
    "evaluate_candidate",
    "grid_scenario",
    "grid_search",
    "objective_from_tick",
    "spsa_gradient",
    "tune",
    "tune_scenario",
]
