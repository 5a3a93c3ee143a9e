"""repro_torch.fleet — cross-stream vet multiplexing for live fleets.

The port of ``repro.fleet``: ``VetMux`` (coalesced mux ticks, fused and
gather paths, checkpoint state in the reference's format), the tick planner
``schedule`` and the per-stream ``AnomalyMonitor``.  ``knobs``,
``scenarios``, ``shard`` and ``transport`` are not ported yet.
"""

from .anomaly import AnomalyMonitor, RegimeShift
from .mux import MuxStats, MuxTick, VetMux
from .schedule import StreamRequest, TickPlan, plan_tick, split_budget

__all__ = [
    "AnomalyMonitor",
    "MuxStats",
    "MuxTick",
    "RegimeShift",
    "StreamRequest",
    "TickPlan",
    "VetMux",
    "plan_tick",
    "split_budget",
]
