"""Shard worker: one shard's ``VetMux`` served over a command connection.

The port of ``repro.fleet.transport.worker``.  ``ShardWorker`` is the
command executor — a thin op table over one shard mux.  One
implementation, two placements: the child-process loop
(``shard_worker_main``) and the driver's in-process oracle channel both
route commands through ``ShardWorker.handle``, so the transport
differential suite compares *drivers* (pipes, retries, checkpoints), never
two codepaths that could drift apart.

On the card each worker is a spawned process with its own CUDA context:
its mux launches the window-vet kernel once per fused tick and its anomaly
monitor the change-point kernel once per monitored tick, in the worker.
Those launches count in the worker's own wrapper counters (each kernel's
``ops.LAUNCHES``), so a traced worker reports each tick's change of them
on its ``worker.tick`` span.  Every reply is host values (``proto``'s
module docstring).
"""

from __future__ import annotations

import os
from typing import Any, Hashable, Optional

from ...kernels.changepoint import ops as _cp
from ...kernels.windowvet import ops as _wv
from ...obs.trace import Tracer, span
from ..mux import VetMux
from .proto import FAULT_EXIT, TickReply, WorkerFault

__all__ = ["ShardWorker", "shard_worker_main"]


class ShardWorker:
    """Executes transport commands against one shard mux.

    The mux is built unbudgeted: the job-level budget is water-filled by
    the driver and arrives as each ``tick`` command's payload (mirroring
    how ``ShardedVetMux`` sets ``m.budget`` around each fan-out tick), so
    worker-side pressure ticks stay unbounded — correctness-driven ring
    drains never truncate to a stale budget.
    """

    def __init__(self, engine, *, tenant_weights=None, urgent_headroom=0):
        self.mux = VetMux(engine, tenant_weights=tenant_weights,
                          urgent_headroom=urgent_headroom)
        self.tracer: Optional[Tracer] = None

    def handle(self, op: str, payload: Any) -> Any:
        return getattr(self, "_op_" + op)(payload)

    # -------------------------------------------------------- observability
    def _op_trace(self, enabled: bool) -> None:
        """Enable/disable worker-side tracing.  Completed spans ride back on
        every ``TickReply`` (drained per tick) and get adopted into the
        driver's trace under this shard's process lane.  NOT journaled by
        the driver (the journal clears at checkpoints); ``_revive`` re-sends
        it explicitly after a respawn."""
        if enabled and self.tracer is None:
            self.tracer = Tracer()
            self.mux.set_tracer(self.tracer)
        elif not enabled and self.tracer is not None:
            self.tracer = None
            self.mux.set_tracer(None)

    # ------------------------------------------------------ mux surface
    def _op_register(self, payload: dict) -> None:
        kw = dict(payload)
        self.mux.register(kw.pop("sid"), **kw)

    def _op_deregister(self, sid: Hashable) -> dict:
        # The stream leaves this process: ship its full state back so the
        # driver can rebuild it host-side (VetStream.from_state).
        return self.mux.deregister(sid).state_dict()

    def _op_feed(self, payload) -> int:
        sid, chunk = payload
        return self.mux.feed(sid, chunk)

    def _op_demand(self, _payload) -> int:
        # Total pending window rows — this shard's input to the driver's
        # split_budget water-fill (same census ShardedVetMux.tick takes).
        return sum(self.mux.stream(sid).pending_windows
                   for sid in self.mux.ids())

    def _op_tick(self, budget: Optional[int]) -> TickReply:
        wv0, cp0 = _wv.LAUNCHES, _cp.LAUNCHES
        with span(self.tracer, "worker.tick") as tick_span:
            self.mux.budget = budget
            try:
                t = self.mux.tick()
            finally:
                # pressure ticks between fan-outs: unbounded
                self.mux.budget = None
            # The kernels this tick launched in this process, as the
            # wrappers count them (0 on the CPU, where they run plain).
            tick_span.set(windowvet_launches=_wv.LAUNCHES - wv0,
                          changepoint_launches=_cp.LAUNCHES - cp0)
        newest = {}
        for sid, res in t.results.items():
            newest[sid] = (None if res is None or res.workers == 0 else
                           (float(res.vet[-1]), float(res.ei[-1]),
                            float(res.oc[-1]), float(res.pr[-1]),
                            int(res.t[-1]), int(res.n[-1])))
        return TickReply(newest=newest, serviced=dict(t.serviced),
                         deferred=dict(t.deferred), urgent=tuple(t.urgent),
                         dispatches=t.dispatches, rows=t.rows,
                         padded_rows=t.padded_rows, flags=t.flags,
                         spans=(tuple(self.tracer.drain())
                                if self.tracer is not None else ()))

    def _op_collect(self, sid: Hashable):
        # Full retained rows for one stream (a host BatchVetResult or None)
        # — the on-demand bulk path the differential suite uses.
        return self.mux.stream(sid).collect()

    # ------------------------------------------------- crash recovery
    def _op_checkpoint(self, _payload) -> dict:
        return self.mux.state_dict()

    def _op_restore(self, state: dict) -> None:
        self.mux.load_state_dict(state)

    def _op_stats(self, _payload):
        return self.mux.stats


def shard_worker_main(conn, spec, tenant_weights, urgent_headroom,
                      platform_hint) -> None:
    """Entry point of one shard worker process (the multiprocessing target).

    Blocks on the pipe for ``(op, payload)`` commands, executes them
    through a ``ShardWorker``, and replies ``("ok", value)`` or
    ``("err", exc_type_name, message)``.  The loop exits on ``shutdown``
    or a closed pipe (driver gone).

    ``platform_hint`` is the parent's ``runtime.platform_default_hint()``:
    it is seeded into ``repro_torch.kernels.runtime`` before the engine is
    built, so the worker resolves the device the parent would
    (``REPRO_TORCH_DEVICE``, inherited via the environment, still wins).
    A worker whose device resolves to ``cuda`` with no card raises
    ``RuntimeError`` at its first dispatch; it crosses the pipe by name and
    is not retried.

    Fault injection (tests only): a ``fault`` command arms a
    ``WorkerFault``; at the armed tick the process ``os._exit``s —
    ``"before"`` loses the tick entirely, ``"mid"`` computes and commits it
    first but dies before replying (see ``proto.WorkerFault``).
    """
    from ...kernels import runtime
    runtime.seed_platform_default(platform_hint)
    worker = ShardWorker(spec.build(), tenant_weights=tenant_weights,
                         urgent_headroom=urgent_headroom)
    armed: Optional[WorkerFault] = None
    ticks = 0
    while True:
        try:
            op, payload = conn.recv()
        except (EOFError, OSError):
            break
        if op == "shutdown":
            conn.send(("ok", None))
            break
        if op == "fault":
            armed = payload
            conn.send(("ok", None))
            continue
        try:
            if op == "tick":
                ticks += 1
                if armed is not None and ticks == armed.at_tick:
                    if armed.mode != "before":
                        worker.handle(op, payload)  # committed, reply lost
                    os._exit(FAULT_EXIT)
            value = worker.handle(op, payload)
        except Exception as exc:  # ship it; the driver re-raises by name
            conn.send(("err", type(exc).__name__, str(exc)))
        else:
            conn.send(("ok", value))
    conn.close()
