"""Profiling substrate: record-level timing (paper §5.2) and ground-truth
simulation (copies of ``repro.profiling.recorder`` and
``repro.profiling.simulator``: the same numpy draws for the same seed)."""

from .recorder import PhaseTimer, RecordProfiler
from .simulator import SimProfile, simulate_job, simulate_records

__all__ = ["PhaseTimer", "RecordProfiler", "SimProfile", "simulate_job",
           "simulate_records"]
