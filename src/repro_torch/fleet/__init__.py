"""repro_torch.fleet — cross-stream vet multiplexing for live fleets.

The port of ``repro.fleet``: ``VetMux`` (coalesced mux ticks, fused and
gather paths, checkpoint state in the reference's format), the tick planner
``schedule``, the per-stream ``AnomalyMonitor`` and ``ShardedVetMux``
(``shard``: K shard muxes, deterministic placement, merged job-level vet).
``knobs``, ``scenarios`` and ``transport`` are not ported yet.
"""

from .anomaly import AnomalyMonitor, RegimeShift
from .mux import MuxStats, MuxTick, VetMux
from .schedule import StreamRequest, TickPlan, plan_tick, split_budget
from .shard import (JobVet, ShardPlacer, ShardTick, ShardedVetMux,
                    job_reduce, merge_job)

__all__ = [
    "AnomalyMonitor",
    "JobVet",
    "MuxStats",
    "MuxTick",
    "RegimeShift",
    "ShardPlacer",
    "ShardTick",
    "ShardedVetMux",
    "StreamRequest",
    "TickPlan",
    "VetMux",
    "job_reduce",
    "merge_job",
    "plan_tick",
    "split_budget",
]
