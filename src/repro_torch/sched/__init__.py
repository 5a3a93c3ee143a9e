"""repro_torch.sched — the online vet tuner.

The port of ``repro.sched``'s tuner (``sched.tuner``: ``VetTuner``, its
SPSA and bandit pieces, the grid oracle and the scenario harnesses).
``sched.straggler`` needs ``core.stats`` (``ks_2samp``) and waits for it
(ROADMAP A.1); ``sched.autotune`` waits for the training stack (ROADMAP
A.12).
"""

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
    "TuneCandidate",
    "TuneReport",
    "VetTuner",
    "elbow_walk",
    "evaluate_candidate",
    "grid_scenario",
    "grid_search",
    "objective_from_tick",
    "spsa_gradient",
    "tune_scenario",
]
