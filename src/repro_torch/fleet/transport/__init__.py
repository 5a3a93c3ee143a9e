"""repro_torch.fleet.transport — the fleet across real worker processes.

The port of ``repro.fleet.transport``, on the ``cuda`` backend by default:
on the card each worker is a spawned process with its own CUDA context,
whose mux launches the fleet's kernels.

``TransportVetMux`` drives one long-lived worker process per shard over
duplex pipes, with the production-executor concerns a process boundary
forces: per-round-trip retries with exponential backoff under a retry
budget, periodic checkpoints plus command journals so a killed worker
resumes mid-job without re-vetting committed windows, and per-shard
accounting merged into every ``ShardTick`` / ``MuxStats``.

The in-process driver (``driver="inprocess"``) runs the identical command
stream without pipes — the differential oracle the test suite locks the
process driver against (``tests/test_torch_transport.py``), and a fallback
where multiprocessing is unavailable.

Layering: ``proto`` (wire types) <- ``worker`` (command executor + process
loop) <- ``driver`` (channels, retries, checkpoints, the mux surface).
"""

from .driver import DRIVERS, ShardHandle, TransportVetMux
from .proto import (
    EngineSpec,
    FAULT_EXIT,
    ShardAccount,
    TickReply,
    TransportError,
    WorkerFault,
)
from .worker import ShardWorker, shard_worker_main

__all__ = [
    "DRIVERS",
    "EngineSpec",
    "FAULT_EXIT",
    "ShardAccount",
    "ShardHandle",
    "ShardWorker",
    "TickReply",
    "TransportError",
    "TransportVetMux",
    "WorkerFault",
    "shard_worker_main",
]
