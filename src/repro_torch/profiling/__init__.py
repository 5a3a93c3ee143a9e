"""Profiling substrate: record-level timing (paper §5.2), ground-truth
simulation and the oversubscription harness (copies of
``repro.profiling.recorder`` and ``repro.profiling.simulator``, with the same
numpy draws for the same seed, and the port of
``repro.profiling.contention``: paper Table 2, Fig. 13)."""

from .contention import make_record_work, run_contended_job
from .recorder import PhaseTimer, RecordProfiler
from .simulator import SimProfile, simulate_job, simulate_records

__all__ = ["PhaseTimer", "RecordProfiler", "SimProfile", "make_record_work",
           "run_contended_job", "simulate_job", "simulate_records"]
