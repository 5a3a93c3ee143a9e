"""Batched, backend-pluggable vet estimation (the port of ``repro.engine``).

    engine = VetEngine(backend="cuda", buckets=64)   # device cuda by default
    batch  = engine.vet_batch(times_matrix)          # (workers, window) -> one call
    batch.vet, batch.ei, batch.oc, batch.pr, batch.t # (workers,) host arrays
    batch.vet_job                                    # mean vet (paper §4.4)

Backends: ``numpy`` (scalar per-row oracle on the host), ``torch``
(batched plain PyTorch on the resolved device), ``cuda`` (the same path
with the hand-written kernels).  ``VetStream`` runs the engine over a ring
buffer, vetting only the windows completed since the last tick.
"""

from .engine import (
    BACKENDS,
    BatchVetResult,
    CacheInfo,
    VetEngine,
    default_engine,
)
from .stream import RingDelta, StreamDelta, StreamStats, VetStream

__all__ = ["BACKENDS", "BatchVetResult", "CacheInfo", "RingDelta",
           "StreamDelta", "StreamStats", "VetEngine", "VetStream",
           "default_engine"]
