"""Cross-process shard driver: pipes, retries, checkpoints, accounting.

The port of ``repro.fleet.transport.driver``.  ``TransportVetMux`` is
``ShardedVetMux`` with the shards moved into real worker processes.  Same
surface (``register`` / ``deregister`` / ``feed`` / ``tick`` / ``flush`` /
``stats``), same deterministic placement (the shared ``ShardPlacer``), same
two-level budget water-filling, same merged ``ShardTick`` — plus the
production-executor concerns a process boundary forces:

- **Bounded worker pool.**  One long-lived worker process per shard
  (started once, reused across ticks — never a process per dispatch), each
  owning a ``VetMux`` on its own engine, driven over a duplex pipe.
- **Retries with exponential backoff.**  Every round trip runs under a
  retry budget: a transport failure (dead process, broken pipe, reply
  timeout) kills the channel, sleeps ``backoff_base * backoff_factor **
  attempt``, revives the worker and re-sends.  Logical errors re-raise
  immediately as their original exception type — they are never retried.
- **Checkpoint / resume.**  After every ``checkpoint_every``-th tick the
  driver pulls each shard's full mux state (ring contents, fingerprints,
  retained rows, staleness counters — ``VetMux.state_dict``) and clears
  that shard's command journal.  Reviving a dead worker replays checkpoint
  + journal (the registers/feeds since), restoring the exact pre-failure
  state, then re-sends the failed command — so a shard killed mid-tick
  resumes without re-vetting committed windows and without skipping any
  (lifetime row/dispatch counters stay equal to the in-process oracle's).
- **Accounting.**  Per-shard round trips, retries, respawns, checkpoints
  and wall-clock (``ShardAccount``) surface on every tick
  (``ShardTick.accounts``) and merge into ``MuxStats``
  (``retries``/``respawns``).
- **One kernel build, before the pool starts.**  When a worker's engine
  will run the CUDA kernels (``backend="cuda"`` on a card), the driver
  builds the kernel library once (``runtime.build_library``: nvcc only,
  no CUDA context) before spawning, so K fresh workers only load it
  instead of racing K nvcc builds past the reply timeout.

``driver="inprocess"`` runs the identical command stream against
``ShardWorker``s in this process — no pipes, nothing to retry.  That is
the differential oracle: the suite locks the process driver to it (and
both to ``ShardedVetMux``) across the scenario bank.
"""

from __future__ import annotations

import multiprocessing as mp
import time
from typing import (
    Any,
    Callable,
    Dict,
    Hashable,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np
import torch

from ...engine import BatchVetResult, VetEngine, VetStream
from ...kernels import runtime
from ...obs.trace import span as _span, timed as _timed
from ..mux import MuxStats, MuxTick, _flush_loop
from ..schedule import split_budget
from ..shard import ShardPlacer, ShardTick
from .proto import (
    EngineSpec,
    LOGICAL_EXCEPTIONS,
    ShardAccount,
    TickReply,
    TransportError,
    WorkerFault,
)
from .worker import ShardWorker, shard_worker_main

__all__ = ["DRIVERS", "ShardHandle", "TransportVetMux"]

DRIVERS = ("process", "inprocess")


class _TransportFailure(Exception):
    """Internal: one round trip failed at the transport level (dead worker,
    broken pipe, reply timeout) — retryable, unlike logical errors."""


class _LocalChannel:
    """In-process 'transport': commands execute synchronously against a
    ``ShardWorker`` living in this process.  The differential oracle —
    identical command stream, no pipes, nothing that can die."""

    def __init__(self, factory: Callable[[], ShardWorker]):
        self._worker = factory()
        self._pending: Optional[Tuple[str, Any]] = None

    @property
    def alive(self) -> bool:
        return True

    def spawn(self) -> None:  # pragma: no cover — never dead
        pass

    def send(self, msg: Tuple[str, Any]) -> None:
        self._pending = msg

    def recv(self, timeout: float) -> tuple:
        op, payload = self._pending
        self._pending = None
        try:
            return ("ok", self._worker.handle(op, payload))
        except Exception as exc:
            return ("err", type(exc).__name__, str(exc))

    def kill(self) -> None:  # pragma: no cover — never dead
        pass

    def close(self) -> None:
        pass


class _ProcessChannel:
    """One shard worker process plus its duplex pipe.

    A transport failure tears the whole channel down (``kill``): the stale
    pipe is discarded with the dead process, so a late reply from a hung
    worker can never desynchronize a fresh command stream — every revive
    starts a new process on a new pipe.
    """

    def __init__(self, ctx, spec: EngineSpec, tenant_weights: dict,
                 urgent_headroom: int):
        self._ctx = ctx
        self._spec = spec
        self._tenant_weights = tenant_weights
        self._urgent_headroom = urgent_headroom
        self._proc = None
        self._conn = None

    @property
    def alive(self) -> bool:
        return self._proc is not None and self._proc.is_alive()

    def spawn(self) -> None:
        self.kill()
        parent, child = self._ctx.Pipe(duplex=True)
        self._proc = self._ctx.Process(
            target=shard_worker_main,
            args=(child, self._spec, self._tenant_weights,
                  self._urgent_headroom,
                  runtime.platform_default_hint()),
            daemon=True)
        self._proc.start()
        child.close()
        self._conn = parent

    def send(self, msg: Tuple[str, Any]) -> None:
        if self._conn is None:
            raise _TransportFailure("worker not started")
        try:
            self._conn.send(msg)
        except (BrokenPipeError, EOFError, OSError) as exc:
            raise _TransportFailure(f"send failed: {exc}") from exc

    def recv(self, timeout: float) -> tuple:
        if self._conn is None:
            raise _TransportFailure("worker not started")
        try:
            if not self._conn.poll(timeout):
                raise _TransportFailure(
                    f"no reply within {timeout:.1f}s (hung worker?)")
            return self._conn.recv()
        except _TransportFailure:
            raise
        except (BrokenPipeError, EOFError, OSError) as exc:
            raise _TransportFailure(f"recv failed: {exc}") from exc

    def kill(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:  # pragma: no cover
                pass
            self._conn = None
        if self._proc is not None:
            if self._proc.is_alive():
                self._proc.terminate()
            self._proc.join(timeout=5)
            self._proc = None

    def close(self) -> None:
        if self._conn is not None and self.alive:
            try:  # graceful first: let the worker loop exit cleanly
                self._conn.send(("shutdown", None))
                self._conn.poll(1.0)
            except (BrokenPipeError, EOFError, OSError):
                pass
        self.kill()


class ShardHandle:
    """Reliable command endpoint for one shard.

    Wraps a channel with the executor concerns: retries with exponential
    backoff under a retry budget, revive (respawn + checkpoint restore +
    journal replay) when the worker died, per-shard accounting, and an
    async ``tick_async``/``finish_tick`` pair so every shard computes its
    tick concurrently instead of serially round-tripping.

    ``sleep`` is injectable so the retry/backoff unit tests assert the
    exact backoff schedule without wall-clock waits.
    """

    def __init__(self, index: int, channel, *, max_retries: int = 3,
                 backoff_base: float = 0.05, backoff_factor: float = 2.0,
                 timeout: float = 60.0, sleep: Callable[[float], None]
                 = time.sleep):
        self.index = index
        self.channel = channel
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_factor = float(backoff_factor)
        self.timeout = float(timeout)
        self._sleep = sleep
        # Crash recovery: last checkpoint + the mutating commands since.
        self.checkpoint_blob: Optional[dict] = None
        self.journal: List[Tuple[str, Any]] = []
        self.ticks_since_checkpoint = 0
        # Accounting (ShardAccount fields).
        self.calls = 0
        self.retries = 0
        self.respawns = 0
        self.checkpoints = 0
        self.elapsed_s = 0.0
        self._async_budget: Optional[int] = None
        self._async_sent = False
        # Observability (repro_torch.obs): when a tracer is attached, every round
        # trip is a ``transport.*`` span on lane ``index`` — and elapsed_s
        # is read off the *same* span stopwatch, so there is exactly one
        # clock source whether tracing is on or off.  ``trace_enabled``
        # mirrors the worker-side state so ``_revive`` can re-enable it
        # (the ``trace`` op is NOT journaled: journals clear at
        # checkpoints).  ``tick_sent_at`` anchors the adoption of this
        # worker's spans into the driver clock.
        self.tracer = None
        self.trace_enabled = False
        self.tick_sent_at = 0.0

    @property
    def account(self) -> ShardAccount:
        return ShardAccount(calls=self.calls, retries=self.retries,
                            respawns=self.respawns,
                            checkpoints=self.checkpoints,
                            elapsed_s=self.elapsed_s)

    # ------------------------------------------------- reliable round trip
    def call(self, op: str, payload: Any, *, journal: bool = False) -> Any:
        """One reliable round trip: send, await, retry transport failures
        with exponential backoff, revive dead workers, re-raise logical
        errors.  ``journal=True`` records the command (after success) for
        replay on a future revive — every state-mutating command between
        checkpoints must journal."""
        reply = self._reliable(op, payload)
        return self._unwrap(op, payload, reply, journal)

    def _reliable(self, op: str, payload: Any) -> tuple:
        # One stopwatch for both accounting and tracing: elapsed_s is the
        # span's own duration (``timed`` measures even with tracer=None),
        # never a second perf_counter pair that could disagree with it.
        sw = _timed(self.tracer, "transport.roundtrip", tid=self.index,
                    shard=self.index, op=op)
        try:
            with sw:
                for attempt in range(self.max_retries + 1):
                    try:
                        if not self.channel.alive:
                            self._revive()
                        self.channel.send((op, payload))
                        return self.channel.recv(self.timeout)
                    except _TransportFailure as exc:
                        self.channel.kill()
                        if attempt >= self.max_retries:
                            raise TransportError(
                                f"shard {self.index}: {op!r} failed after "
                                f"{attempt} retries: {exc}") from exc
                        self.retries += 1
                        sw.set(retries=attempt + 1)
                        self._sleep(self.backoff_base
                                    * self.backoff_factor ** attempt)
        finally:
            self.elapsed_s += sw.dur

    def _unwrap(self, op: str, payload: Any, reply: tuple,
                journal: bool) -> Any:
        if reply[0] == "err":
            _, name, msg = reply
            raise LOGICAL_EXCEPTIONS.get(name, TransportError)(msg)
        self.calls += 1
        if journal:
            self.journal.append((op, payload))
        return reply[1]

    def _revive(self) -> None:
        """Respawn a dead worker and roll it forward: restore the last
        checkpoint, then replay the journaled mutations since (register /
        deregister / feed).  The command that observed the death is
        re-sent by the retry loop after this returns, so a shard killed
        mid-tick re-ticks from exactly its pre-tick state — committed
        windows are never re-vetted, pending ones never skipped."""
        self.respawns += 1
        self.channel.spawn()
        if self.checkpoint_blob is not None:
            self._roundtrip("restore", self.checkpoint_blob)
        for op, payload in self.journal:
            self._roundtrip(op, payload)
        if self.trace_enabled:
            # Not journaled (journals clear at checkpoints), so the fresh
            # worker must be told explicitly to keep tracing.
            self._roundtrip("trace", True)

    def _roundtrip(self, op: str, payload: Any) -> Any:
        # Replay primitive: transport failures propagate to the retry loop,
        # but a *logical* error here is fatal — a command that succeeded
        # before must succeed on replay, or snapshot and journal disagree.
        self.channel.send((op, payload))
        reply = self.channel.recv(self.timeout)
        if reply[0] == "err":
            raise TransportError(
                f"shard {self.index}: resume replay of {op!r} failed: "
                f"{reply[2]}")
        return reply[1]

    # ----------------------------------------------------- parallel ticks
    def tick_async(self, budget: Optional[int]) -> None:
        """Fire a tick round trip without blocking on the reply, so all
        shards vet concurrently; ``finish_tick`` completes it.  A failure
        here just marks the fast path dead — ``finish_tick`` falls back to
        the full reliable path (revive + retry)."""
        self._async_budget = budget
        self._async_sent = False
        sw = _timed(self.tracer, "transport.send", tid=self.index,
                    shard=self.index, op="tick")
        try:
            with sw:
                if not self.channel.alive:
                    self._revive()
                if self.tracer is not None:
                    # Driver-clock anchor for adopting this tick's
                    # worker-side spans (Tracer.adopt at=).
                    self.tick_sent_at = self.tracer.now()
                self.channel.send(("tick", budget))
                self._async_sent = True
        except _TransportFailure:
            self.channel.kill()
        finally:
            self.elapsed_s += sw.dur

    def finish_tick(self) -> TickReply:
        budget = self._async_budget
        self._async_budget = None
        if self._async_sent:
            sw = _timed(self.tracer, "transport.recv", tid=self.index,
                        shard=self.index, op="tick")
            try:
                with sw:
                    reply = self.channel.recv(self.timeout)
            except _TransportFailure:
                self.channel.kill()
                self.retries += 1
                self._sleep(self.backoff_base)
            else:
                return self._unwrap("tick", budget, reply, journal=False)
            finally:
                self.elapsed_s += sw.dur
        return self.call("tick", budget)

    def close(self) -> None:
        self.channel.close()


def _build_kernels_for(specs: Sequence[EngineSpec]) -> None:
    """Build the CUDA kernel library here, once, when any worker's engine
    will launch the kernels (the ``cuda`` backend on a device that resolves
    to a card present in this process).  ``build_library`` runs nvcc only;
    the workers then ``ctypes``-load the finished file.  Without a card
    nothing is built, and such a worker raises at its first dispatch."""
    if any(s.backend == "cuda"
           and runtime.resolve_device(s.device).type == "cuda"
           for s in specs) and torch.cuda.is_available():
        runtime.build_library()


class TransportVetMux:
    """``ShardedVetMux`` across real worker processes.

    Drop-in at the sharded-fleet call sites (same
    ``register``/``feed``/``tick``/``flush``/``stats`` surface, same merged
    ``ShardTick``), with each shard mux living in its own long-lived
    worker process behind retries, checkpoints, and accounting — see the
    module docstring.  Close it when done (``close()`` / context manager):
    worker processes are daemonic but graceful shutdown beats reaping.

    Surface deltas forced by the process boundary, all loud:

    - ``register`` returns the chosen *shard index*, not a ``VetStream``
      (the stream lives in the worker); ``stream()`` raises with guidance;
      ``collect(sid)`` fetches a stream's full retained rows on demand;
      ``deregister`` ships the stream's state back and rebuilds it
      host-side, so churn still returns a usable ``VetStream``.
    - ``tick().results`` carries each stream's *newest-window* row only
      (one row per stream — exactly what ``vet_job``/``job_reduce`` fold),
      keeping tick round trips O(streams) scalars.
    - attaching an existing ``stream=`` is rejected: a live host-side
      stream cannot be pinned to another process's engine.

    Args:
        shards / engines / engine / backend / budget / tenant_weights /
            urgent_headroom / placement: exactly ``ShardedVetMux`` (engines
            may also be ``EngineSpec``s; a template ``engine``'s config is
            shipped, never the engine object; the default shard engine is
            ``VetEngine(backend, buckets=64)`` with ``backend="cuda"``).
        driver: ``"process"`` (real workers, default) or ``"inprocess"``
            (the same command stream against in-process workers — the
            differential oracle, and a no-multiprocessing fallback).
        max_retries: transport retries per round trip before
            ``TransportError`` (the retry budget).
        backoff_base / backoff_factor: exponential backoff schedule —
            attempt ``i`` sleeps ``backoff_base * backoff_factor ** i``.
        timeout: seconds to wait for any single reply (a hung worker is a
            transport failure: killed, revived, retried).
        checkpoint_every: pull shard checkpoints every N successful ticks
            (1 = after every tick, the tightest resume window; larger
            values trade checkpoint traffic for replaying more feeds —
            and re-vetting the un-checkpointed ticks' windows — on crash).
        mp_context: multiprocessing start method (default ``"spawn"``: a
            forked child of a process that holds a CUDA context cannot use
            the card).
        sleep: backoff sleeper, injectable for tests.
        tracer: optional ``repro_torch.obs.Tracer``.  When set, driver-side work
            traces onto pid 0 (``fleet.*`` on lane 0, ``transport.*`` on
            lane = shard index) and every worker is told to trace too —
            its spans ride back on each ``TickReply`` and are adopted into
            this tracer under pid ``shard + 1``, yielding one cross-process
            trace.

    Example::

        >>> fleet = TransportVetMux(2, backend="numpy", driver="inprocess")
        >>> for w in range(4):
        ...     _ = fleet.register(w, window=8, stride=4)
        >>> for w in range(4):
        ...     _ = fleet.feed(w, np.linspace(1e-3, 2e-3, 16) * (w + 1))
        >>> tick = fleet.tick()
        >>> (tick.rows, len(tick.shards), tick.vet_job >= 1.0)
        (12, 2, True)
        >>> fleet.close()
    """

    def __init__(self, shards: Optional[int] = None, *,
                 engines: Optional[Sequence[Union[VetEngine, EngineSpec]]]
                 = None,
                 engine: Optional[Union[VetEngine, EngineSpec]] = None,
                 backend: str = "cuda",
                 budget: Optional[int] = None,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 urgent_headroom: int = 0,
                 placement: str = "pack",
                 driver: str = "process",
                 max_retries: int = 3,
                 backoff_base: float = 0.05,
                 backoff_factor: float = 2.0,
                 timeout: float = 60.0,
                 checkpoint_every: int = 1,
                 mp_context: Union[str, Any] = "spawn",
                 sleep: Callable[[float], None] = time.sleep,
                 tracer=None):
        if driver not in DRIVERS:
            raise ValueError(
                f"driver must be one of {DRIVERS}, got {driver!r}")
        if engines is not None and engine is not None:
            raise ValueError("pass engines= (one per shard) or engine= "
                             "(a template), not both")
        if engines is not None:
            engines = list(engines)
            if not engines:
                raise ValueError("engines must name at least one shard")
            if shards is not None and shards != len(engines):
                raise ValueError(
                    f"shards={shards} but {len(engines)} engines given")
            specs = [e if isinstance(e, EngineSpec)
                     else EngineSpec.from_engine(e) for e in engines]
        else:
            shards = 1 if shards is None else int(shards)
            if shards < 1:
                raise ValueError(f"shards must be >= 1, got {shards}")
            if engine is not None:
                spec = (engine if isinstance(engine, EngineSpec)
                        else EngineSpec.from_engine(engine))
            else:
                # ShardedVetMux's default shard engine: backend, buckets=64.
                spec = EngineSpec.from_engine(VetEngine(backend, buckets=64))
            specs = [spec] * shards
        if budget is not None:
            budget = int(budget)
            if budget < 1:
                raise ValueError(
                    f"budget must be >= 1 window row, got {budget}")
        checkpoint_every = int(checkpoint_every)
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1 tick, got {checkpoint_every}")
        self.budget = budget
        self.driver = driver
        self.checkpoint_every = checkpoint_every
        self._specs = specs
        self._placer = ShardPlacer(len(specs), placement)
        self._ticks = 0
        self._host_engine: Optional[VetEngine] = None
        tw = dict(tenant_weights or {})
        uh = int(urgent_headroom)
        if driver == "process":
            ctx = (mp.get_context(mp_context) if isinstance(mp_context, str)
                   else mp_context)
            _build_kernels_for(specs)
            channels = [_ProcessChannel(ctx, s, tw, uh) for s in specs]
        else:
            channels = [
                _LocalChannel(lambda s=s: ShardWorker(
                    s.build(), tenant_weights=tw, urgent_headroom=uh))
                for s in specs
            ]
        self._handles = [
            ShardHandle(k, ch, max_retries=max_retries,
                        backoff_base=backoff_base,
                        backoff_factor=backoff_factor, timeout=timeout,
                        sleep=sleep)
            for k, ch in enumerate(channels)
        ]
        # The pool starts now, once — workers are reused for the fleet's
        # lifetime (the initial spawn is not a respawn).
        for ch in channels:
            if not ch.alive:
                ch.spawn()
        self.tracer = None
        if tracer is not None:
            self.set_tracer(tracer)

    def set_tracer(self, tracer) -> None:
        """Attach (or detach, with ``None``) a driver-side tracer and toggle
        worker-side tracing to match.  The ``trace`` op round-trips now so
        workers start draining spans from the very next tick."""
        self.tracer = tracer
        enabled = tracer is not None
        for h in self._handles:
            h.tracer = tracer
            if h.trace_enabled != enabled:
                h.call("trace", enabled)
                h.trace_enabled = enabled

    def __repr__(self) -> str:
        return (f"TransportVetMux(shards={self.n_shards}, "
                f"driver={self.driver!r}, streams={len(self._placer.placed)}, "
                f"budget={self.budget}, ticks={self._ticks})")

    def __enter__(self) -> "TransportVetMux":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ----------------------------------------------------------- topology
    @property
    def n_shards(self) -> int:
        return len(self._handles)

    @property
    def placement(self) -> str:
        return self._placer.policy

    @property
    def assignment(self) -> Dict[Hashable, int]:
        """stream_id -> shard index, in registration order (a copy)."""
        return {sid: p.shard for sid, p in self._placer.placed.items()}

    def shard_of(self, stream_id: Hashable) -> int:
        return self._placer.shard_of(stream_id)

    def ids(self) -> Iterator[Hashable]:
        """Stream ids in registration order (across all shards)."""
        return iter(self._placer.placed)

    def __contains__(self, stream_id: Hashable) -> bool:
        return stream_id in self._placer.placed

    def __len__(self) -> int:
        return len(self._placer.placed)

    # ------------------------------------------------------- registration
    def register(self, stream_id: Hashable, *, window: Optional[int] = None,
                 stride: int = 1, capacity: Optional[int] = None,
                 history: Optional[int] = None, priority: float = 0.0,
                 tenant: str = "default", stream=None) -> int:
        """Register a stream on a deterministically chosen shard worker.

        Same placement as ``ShardedVetMux.register`` (shared placer) —
        returns the chosen shard index instead of the worker-resident
        ``VetStream``.
        """
        if stream is not None:
            raise ValueError(
                "attached streams cannot cross the process boundary; "
                "register with window geometry and let the shard worker "
                "build the stream on its own engine")
        if stream_id in self._placer.placed:
            raise ValueError(f"stream {stream_id!r} is already registered")
        if window is None:
            raise ValueError(
                "register needs window= (the shard worker creates the "
                "stream on its own engine)")
        window = int(window)
        cap = int(capacity) if capacity is not None else 4 * window
        weight = ShardPlacer.delta_weight(window, int(stride), cap)
        k = self._placer.choose(weight, window)
        self._handles[k].call(
            "register",
            {"sid": stream_id, "window": window, "stride": int(stride),
             "capacity": capacity, "history": history,
             "priority": float(priority), "tenant": str(tenant)},
            journal=True)
        self._placer.add(stream_id, k, weight, window)
        return k

    def deregister(self, stream_id: Hashable) -> VetStream:
        """Remove a stream; its full state ships back from the worker and
        is rebuilt host-side, so churn still returns a usable standalone
        ``VetStream`` (bound to a host engine of the same spec)."""
        k = self._placer.shard_of(stream_id)
        state = self._handles[k].call("deregister", stream_id, journal=True)
        self._placer.remove(stream_id)
        if self._host_engine is None:
            self._host_engine = self._specs[k].build()
        return VetStream.from_state(self._host_engine, state)

    def stream(self, stream_id: Hashable) -> VetStream:
        self._placer.require(stream_id)
        raise TypeError(
            f"stream {stream_id!r} lives in shard worker process "
            f"{self._placer.shard_of(stream_id)}; use collect(stream_id) "
            f"for its retained rows, or deregister(stream_id) to pull the "
            f"stream back into this process")

    def collect(self, stream_id: Hashable) -> Optional[BatchVetResult]:
        """Full retained rows for one stream, fetched from its shard
        worker (``None`` while no window is vetted).  The bulk path —
        tick results only carry newest-window rows."""
        k = self._placer.shard_of(stream_id)
        return self._handles[k].call("collect", stream_id)

    # ------------------------------------------------------------- ingest
    def feed(self, stream_id: Hashable, times) -> int:
        """Append a chunk to one stream in its shard worker.

        Ring pressure ticks the *owning worker's* mux locally (unbounded,
        correctness-driven), exactly like the in-process fleet — feeds
        never block on other shards.
        """
        k = self._placer.shard_of(stream_id)
        chunk = np.ascontiguousarray(np.asarray(times, dtype=np.float64))
        return self._handles[k].call("feed", (stream_id, chunk),
                                     journal=True)

    # --------------------------------------------------------------- tick
    def tick(self) -> ShardTick:
        """Fan a tick out to every shard worker in parallel, then merge.

        Same two-level budget water-fill as ``ShardedVetMux.tick`` (each
        shard reports pending demand, ``split_budget`` slices the job
        budget), with the per-shard ticks running concurrently in their
        worker processes.  After the merge, shards due a checkpoint are
        checkpointed and their journals cleared.
        """
        self._ticks += 1
        with _span(self.tracer, "fleet.tick", shards=self.n_shards,
                   streams=len(self._placer.placed)):
            with _span(self.tracer, "fleet.plan", shards=self.n_shards):
                if self.budget is None:
                    budgets: Tuple[Optional[int], ...] \
                        = (None,) * self.n_shards
                else:
                    demands = [h.call("demand", None) for h in self._handles]
                    budgets = tuple(split_budget(self.budget, demands))
            for h, b in zip(self._handles, budgets):
                h.tick_async(b)
            replies = [h.finish_tick() for h in self._handles]
            if self.tracer is not None:
                for h, r in zip(self._handles, replies):
                    # Worker spans rode back on the reply; re-anchor them to
                    # the driver clock at the moment this tick was sent, on
                    # the worker's own process lane.
                    self.tracer.adopt(r.spans, pid=h.index + 1,
                                      at=h.tick_sent_at,
                                      name=f"shard{h.index}")
            ticks = [self._as_mux_tick(r) for r in replies]
            self._checkpoint_due()
            results: Dict[Hashable, Optional[BatchVetResult]] = {}
            serviced: Dict[Hashable, int] = {}
            deferred: Dict[Hashable, int] = {}
            with _span(self.tracer, "fleet.merge", shards=self.n_shards):
                for sid, placed in self._placer.placed.items():  # reg. order
                    t = ticks[placed.shard]
                    results[sid] = t.results[sid]
                    if sid in t.serviced:
                        serviced[sid] = t.serviced[sid]
                    if sid in t.deferred:
                        deferred[sid] = t.deferred[sid]
        return ShardTick(
            results=results, serviced=serviced, deferred=deferred,
            urgent=tuple(sid for t in ticks for sid in t.urgent),
            dispatches=sum(t.dispatches for t in ticks),
            rows=sum(t.rows for t in ticks),
            padded_rows=sum(t.padded_rows for t in ticks),
            shards=tuple(ticks), budgets=budgets, accounts=self.accounts,
            flags=tuple(f for t in ticks for f in t.flags))

    @staticmethod
    def _as_mux_tick(reply: TickReply) -> MuxTick:
        results = {
            sid: (None if row is None else BatchVetResult(
                vet=np.asarray([row[0]]), ei=np.asarray([row[1]]),
                oc=np.asarray([row[2]]), pr=np.asarray([row[3]]),
                t=np.asarray([row[4]], dtype=np.int32),
                n=np.asarray([row[5]], dtype=np.int64)))
            for sid, row in reply.newest.items()
        }
        return MuxTick(results=results, serviced=reply.serviced,
                       deferred=reply.deferred, urgent=reply.urgent,
                       dispatches=reply.dispatches, rows=reply.rows,
                       padded_rows=reply.padded_rows,
                       flags=tuple(reply.flags))

    def _checkpoint_due(self) -> None:
        for h in self._handles:
            h.ticks_since_checkpoint += 1
            if h.ticks_since_checkpoint >= self.checkpoint_every:
                h.checkpoint_blob = h.call("checkpoint", None)
                h.journal.clear()
                h.ticks_since_checkpoint = 0
                h.checkpoints += 1

    def flush(self, max_ticks: int = 1_000_000) -> ShardTick:
        """Tick until no shard has deferred work; returns the last tick.
        At most ``max_ticks`` ticks, the first included — the same shared
        boundary as ``VetMux.flush`` / ``ShardedVetMux.flush``."""
        return _flush_loop(self.tick, max_ticks)

    # -------------------------------------------------------- observation
    @property
    def stats(self) -> MuxStats:
        """Merged lifetime counters, fetched live from every shard worker;
        ``retries``/``respawns`` report this driver's transport work."""
        per = [MuxStats(*h.call("stats", None)) for h in self._handles]
        return MuxStats(ticks=self._ticks,
                        dispatches=sum(s.dispatches for s in per),
                        rows=sum(s.rows for s in per),
                        padded_rows=sum(s.padded_rows for s in per),
                        deferred=sum(s.deferred for s in per),
                        streams=len(self._placer.placed),
                        retries=sum(h.retries for h in self._handles),
                        respawns=sum(h.respawns for h in self._handles),
                        anomalies=sum(s.anomalies for s in per))

    @property
    def shard_stats(self) -> Tuple[MuxStats, ...]:
        """Per-shard worker ``MuxStats``, in shard order."""
        return tuple(MuxStats(*h.call("stats", None))
                     for h in self._handles)

    @property
    def accounts(self) -> Tuple[ShardAccount, ...]:
        """Per-shard transport accounting so far, in shard order."""
        return tuple(h.account for h in self._handles)

    # -------------------------------------------------------------- misc
    def inject_fault(self, shard: int, at_tick: int,
                     mode: str = "before") -> None:
        """Arm a test-only crash in one shard worker (``WorkerFault``):
        the worker ``os._exit``s at its ``at_tick``-th tick command.
        Process driver only — the in-process oracle has nothing to kill."""
        if self.driver != "process":
            raise ValueError(
                "fault injection needs driver='process' (the in-process "
                "oracle has no worker to kill)")
        if mode not in ("before", "mid"):
            raise ValueError(f"fault mode must be 'before' or 'mid', "
                             f"got {mode!r}")
        self._handles[shard].call("fault", WorkerFault(int(at_tick), mode))

    def close(self) -> None:
        """Shut the worker pool down (graceful, then reaped).  Idempotent;
        also runs on context-manager exit."""
        for h in self._handles:
            h.close()
