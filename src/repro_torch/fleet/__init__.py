"""repro_torch.fleet — cross-stream vet multiplexing for live fleets.

The port of ``repro.fleet``: ``VetMux`` (coalesced mux ticks, fused and
gather paths, checkpoint state in the reference's format), the tick planner
``schedule``, the per-stream ``AnomalyMonitor``, ``ShardedVetMux``
(``shard``: K shard muxes, deterministic placement, merged job-level vet),
``TransportVetMux`` (``transport``: the shards in spawned worker processes
behind retries, checkpoint/resume and accounting), the tuner's write-back
seam ``knobs`` and the seed-stable scenario bank ``scenarios``.
"""

from .anomaly import AnomalyMonitor, RegimeShift
from .knobs import Knob, KnobHooks, mux_knob_hooks
from .mux import MuxStats, MuxTick, VetMux
from .scenarios import (ANOMALY_SCENARIOS, SCENARIOS, FleetEvent,
                        FleetScenario, StreamSpec, TunableScenario, build,
                        play, tunable)
from .schedule import StreamRequest, TickPlan, plan_tick, split_budget
from .shard import (JobVet, ShardPlacer, ShardTick, ShardedVetMux,
                    job_reduce, merge_job)
from .transport import (EngineSpec, ShardAccount, TransportError,
                        TransportVetMux)

__all__ = [
    "ANOMALY_SCENARIOS",
    "SCENARIOS",
    "AnomalyMonitor",
    "EngineSpec",
    "FleetEvent",
    "FleetScenario",
    "JobVet",
    "Knob",
    "KnobHooks",
    "MuxStats",
    "MuxTick",
    "RegimeShift",
    "ShardAccount",
    "ShardPlacer",
    "ShardTick",
    "ShardedVetMux",
    "StreamRequest",
    "StreamSpec",
    "TickPlan",
    "TransportError",
    "TransportVetMux",
    "TunableScenario",
    "VetMux",
    "build",
    "job_reduce",
    "merge_job",
    "mux_knob_hooks",
    "plan_tick",
    "play",
    "split_budget",
    "tunable",
]
