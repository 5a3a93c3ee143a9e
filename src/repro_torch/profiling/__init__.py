"""Ground-truth record-time simulation (a copy of
``repro.profiling.simulator``: the same numpy draws for the same seed)."""

from .simulator import SimProfile, simulate_job, simulate_records

__all__ = ["SimProfile", "simulate_job", "simulate_records"]
