"""Wire protocol for the cross-process shard transport.

The port of ``repro.fleet.transport.proto``.  Everything that crosses a
shard worker's pipe is defined here, so the driver
(``repro_torch.fleet.transport.driver``) and the worker loop
(``repro_torch.fleet.transport.worker``) agree by construction:

- **Commands** are ``(op, payload)`` tuples.  The ops mirror the in-process
  mux surface (``register`` / ``deregister`` / ``feed`` / ``tick`` /
  ``collect`` / ``stats``) plus the transport-only lifecycle ops
  (``demand`` for budget water-filling, ``checkpoint`` / ``restore`` for
  crash recovery, ``fault`` for test-only crash injection, ``shutdown``).
- **Replies** are ``("ok", value)`` or ``("err", exc_type_name, message)``.
  A logical error — bad stream id, ring overrun, stale delta, a worker
  asked for a CUDA device it does not have — crosses the pipe *by name*
  and re-raises driver-side as its original exception type
  (``LOGICAL_EXCEPTIONS``); it is never retried, because re-sending a
  command the worker correctly rejected cannot succeed.  Only *transport*
  failures (dead process, broken pipe, reply timeout) are retryable.
- **Replies hold host values only**: numpy arrays, Python scalars and
  NamedTuples of them.  ``import torch`` registers reducers that would
  send a CUDA tensor through CUDA IPC, and such a tensor dies with the
  worker that made it, so no tensor ever rides a reply.
- **Tick replies ship scalars, not row arrays.**  A shard reduces its tick
  to per-stream newest-window rows (six numbers each — exactly what
  ``job_reduce`` folds into a ``JobVet`` partial) plus the service /
  deferral / dispatch counters, so a tick round trip is O(streams) small
  values no matter how many window rows the shard vetted.  Full retained
  rows stay in the worker; ``collect`` fetches them on demand.
"""

from __future__ import annotations

from typing import Dict, Hashable, NamedTuple, Optional, Tuple

__all__ = [
    "EngineSpec",
    "FAULT_EXIT",
    "LOGICAL_EXCEPTIONS",
    "NewestRow",
    "ShardAccount",
    "TickReply",
    "TransportError",
    "WorkerFault",
]

# Exit code of a fault-injected worker death (distinguishable from a real
# crash in test output).
FAULT_EXIT = 17

# Exception types a worker may raise logically; they cross the pipe by
# name and re-raise driver-side as themselves.  Anything unlisted arrives
# as TransportError (still not retried — the reply did arrive).
LOGICAL_EXCEPTIONS = {
    "ValueError": ValueError,
    "KeyError": KeyError,
    "TypeError": TypeError,
    "RuntimeError": RuntimeError,
    "IndexError": IndexError,
    "OverflowError": OverflowError,
}


class TransportError(RuntimeError):
    """A shard worker failed beyond its transport retry budget (the process
    kept dying or hanging), or a checkpoint-resume replay diverged.
    Logical errors are not transport errors — they re-raise as their
    original type and consume no retries."""


class EngineSpec(NamedTuple):
    """Pickle-safe constructor recipe for a shard worker's ``VetEngine``.

    Engines themselves never cross the pipe — result caches, dispatch
    counters and the resolved device are per-process artifacts — so the
    driver ships the configuration and each worker builds its own engine
    from it.  ``device`` carries the *unresolved* argument (``None`` = the
    ``kernels.runtime`` policy): the worker resolves it on its first
    dispatch, seeded with the parent's policy
    (``runtime.seed_platform_default``); ``REPRO_TORCH_DEVICE``, inherited
    through the worker's environment, overrides every worker at once.
    """

    backend: str
    omega: int
    buckets: Optional[int]
    cut_space: str
    device: Optional[str]
    fused: bool
    cache_size: int

    @classmethod
    def from_engine(cls, engine) -> "EngineSpec":
        device = engine._device_arg
        return cls(backend=engine.backend, omega=engine.omega,
                   buckets=engine.buckets, cut_space=engine.cut_space,
                   device=None if device is None else str(device),
                   fused=engine.fused, cache_size=engine._cache_size)

    def build(self):
        from ...engine import VetEngine
        return VetEngine(self.backend, omega=self.omega, buckets=self.buckets,
                         cut_space=self.cut_space, device=self.device,
                         fused=self.fused, cache_size=self.cache_size)


# (vet, ei, oc, pr, t, n) of a stream's newest complete window — the
# scalars job_reduce needs, in BatchVetResult field order.
NewestRow = Tuple[float, float, float, float, int, int]


class TickReply(NamedTuple):
    """One shard's tick outcome as shipped back over the pipe.

    ``newest[sid]`` is the stream's newest-window row (``None`` while the
    stream has no complete window); the remaining fields are the shard
    ``MuxTick``'s counters verbatim.  The driver rebuilds a one-row
    ``MuxTick`` per shard from this, so ``ShardTick.job`` / ``vet_job``
    merge identically to the in-process fleet.
    """

    newest: Dict[Hashable, Optional[NewestRow]]
    serviced: Dict[Hashable, int]
    deferred: Dict[Hashable, int]
    urgent: Tuple[Hashable, ...]
    dispatches: int
    rows: int
    padded_rows: int
    # Regime-shift flags the worker-side anomaly monitor raised this tick
    # (``fleet.anomaly.RegimeShift`` of Python scalars, a top-level
    # NamedTuple, so the tuple pickles over the pipe as-is).  Defaulted so
    # a checkpoint journal recorded before this field replays cleanly.
    flags: tuple = ()
    # Worker-side SpanRecords drained since the last reply (empty unless
    # the driver enabled tracing via the ``trace`` op).
    spans: tuple = ()


class ShardAccount(NamedTuple):
    """Per-shard end-of-run transport accounting
    (``TransportVetMux.accounts`` / ``ShardTick.accounts``)."""

    calls: int  # commands completed successfully (round trips)
    retries: int  # round trips re-attempted after a transport failure
    respawns: int  # worker processes restarted after a crash/hang
    checkpoints: int  # checkpoints taken
    elapsed_s: float  # wall-clock spent in round trips to this shard


class WorkerFault(NamedTuple):
    """Test-only crash injection, armed via the ``fault`` command.

    The worker ``os._exit``s at its ``at_tick``-th tick command:
    ``"before"`` dies before any work (the tick is lost entirely),
    ``"mid"`` dies after the shard mux computed *and committed* the tick
    but before any reply or checkpoint leaves the process — the torn
    dispatch that checkpoint-resume must absorb without re-vetting
    committed windows or skipping any.
    """

    at_tick: int  # 1-based count of tick commands in the worker's life
    mode: str = "before"  # "before" | "mid"
