"""VetStream: incremental sliding-window vetting over a live record stream.

The port of ``repro.engine.stream`` (numpy only; the engine does the
device work).

``VetEngine.vet_sliding`` answers "vet every window of this buffer" in one
batched call, and the engine's result cache makes a *repeat* of the identical
call free — but a live consumer (dashboard tick, straggler controller,
autotuner) never repeats the identical call: every tick the buffer has grown
by a chunk, so the whole buffer is re-gathered, re-hashed and re-vetted even
though only a handful of windows near the head are new.  ``VetStream`` is the
streaming path:

- **Ring buffer.**  A fixed-capacity ring of record times; ``append(chunk)``
  is O(chunk) regardless of how many records the stream has ever seen.
  Logical stream position ``p`` lives in ring slot ``p % capacity``, so a
  window's rows gather with one vectorized modular index.
- **Rolling fingerprint.**  Appends fold into a running blake2b digest —
  O(chunk), never a re-hash of the whole buffer.  The fingerprint (plus an
  epoch counter bumped by explicit invalidation) keys the engine-cache
  entries for each incremental dispatch, so replaying the same stream into
  the same engine hits the cache without hashing any matrix.
- **Incremental tick.**  ``tick()`` vets only the windows that became
  complete since the last tick — one batched engine dispatch over the delta —
  and splices the new rows into the accumulated per-window results.  Rows for
  old windows are reused from the previous tick, never re-vetted.  Each tick
  returns a ``BatchVetResult`` over all retained complete windows so far,
  equal to ``engine.vet_sliding(prefix, window, stride)`` on the same logical
  prefix (bitwise for the numpy backend; the torch/cuda backends carry their
  usual differential contracts — see ``tests/test_vet_stream.py``).
- **Invalidation-aware caching.**  Mutating history is explicit:
  ``amend(start, values)`` rewrites resident records, re-keys the fingerprint
  (epoch tag) and re-vets exactly the windows that saw the amended records on
  the next tick; ``invalidate()`` is the blanket hook ("I changed the ring
  under you") that re-vets every window still fully resident.  Either way a
  stale cache hit is impossible: pre-mutation keys are never issued again.
- **Mux primitives.**  The tick is factored into ``drain()`` (gather the
  unvetted delta matrix + its content-pure cache key, side-effect free),
  ``commit(delta, rows)`` (splice externally computed rows and advance the
  vetted watermark) and ``collect()`` (the retained-result view).  ``tick()``
  is exactly drain -> one engine dispatch -> commit -> collect; a
  ``repro_torch.fleet.VetMux`` drains many streams, coalesces their deltas into
  shape-bucketed batched dispatches, and commits each stream's slice — the
  per-stream results are identical by construction.

The stream guarantees oracle equality only while every newly completed window
is still fully resident at tick time; if appends outrun the ring
(``capacity`` too small or ticks too rare), ``tick()`` raises instead of
silently skipping windows.  ``feed()`` is the self-managing ingest wrapper:
it sub-chunks an arbitrarily large append and ticks exactly when a further
append could overrun an unvetted window, so callers never track the budget
themselves.

Memory: the ring is O(capacity) records.  By default the accumulated result
rows are six scalars per complete window (~48 bytes) for the life of the
stream — the full prefix-oracle contract.  ``history=H`` bounds that: only
the newest ``H`` window rows are retained (oldest evicted past the cap, with
``first_retained`` naming the first surviving window), so an indefinitely
long stream holds O(capacity + H) memory while every retained row still
equals the corresponding batch-oracle row.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional

import numpy as np

from ..obs.trace import span as _span
from .engine import BatchVetResult, VetEngine, default_engine

__all__ = ["RingDelta", "StreamDelta", "StreamStats", "VetStream"]

_GROW = 64  # initial per-field result capacity (windows); grows as needed


class StreamStats(NamedTuple):
    """Counters for one stream (``VetStream.stats``)."""

    ticks: int  # tick() calls
    records: int  # records ever appended
    windows: int  # complete windows so far
    vetted: int  # window rows computed by engine dispatches
    reused: int  # window rows served from earlier ticks (sum over ticks)
    epoch: int  # invalidation epoch (amend/invalidate bumps)
    evicted: int  # window rows dropped by the bounded history cap


class StreamDelta(NamedTuple):
    """An unvetted window delta drained from a stream (``VetStream.drain``).

    ``matrix`` rows are windows ``[start, start + count)`` of the stream, in
    window order; ``key`` is the engine-cache key for this exact delta — a
    pure function of the (content-fingerprinted) append/amend history, so a
    replay of the same stream hits the cache without hashing the matrix.
    Draining is side-effect free: the delta only takes effect when passed to
    ``commit`` with its computed rows.
    """

    start: int  # first window index covered by this delta
    count: int  # number of windows in this delta
    matrix: np.ndarray  # (count, window) float64 gather of the delta windows
    key: tuple  # content-pure engine-cache key for these rows
    epoch: int  # stream epoch at drain time (commit rejects a mismatch)


class RingDelta(NamedTuple):
    """The fused-path twin of ``StreamDelta`` (``VetStream.drain_ring``).

    Instead of materializing the (count, window) gather matrix, it hands the
    engine's fused kernel the contiguous ring span covering the delta plus
    ring-relative window starts — memory O(span) <= O(ring), never
    O(windows x window).  ``commit`` accepts either delta type (it only
    reads the watermark/epoch/count fields).
    """

    start: int  # first window index covered by this delta
    count: int  # number of windows in this delta
    arena: np.ndarray  # (span,) float64 stream-order span covering the delta
    starts: np.ndarray  # (count,) int64 window starts relative to arena[0]
    window: int  # records per window
    key: tuple  # content-pure engine-cache key for these rows
    epoch: int  # stream epoch at drain time (commit rejects a mismatch)


class VetStream:
    """Incremental rolling-buffer vetting bound to one ``VetEngine``.

    Window ``k`` covers logical records ``[k*stride, k*stride + window)`` of
    the append stream — the same convention as ``vet_sliding``.  Usage::

        stream = VetStream(engine, window=512, stride=256)
        for chunk in source:
            stream.append(chunk)          # O(chunk)
            res = stream.tick()           # vets only newly complete windows
            if res is not None:
                dashboard.update(res.vet[-1], res.vet_job)

    ``capacity`` bounds resident records (default ``4 * window``); it must be
    at least ``window``, and between two ticks you may append at most
    ``capacity - window - stride + 1`` records without losing a window.
    ``history`` (optional) caps retained result rows: past the cap the oldest
    rows are evicted and ``tick()`` returns only the newest ``history``
    windows (``first_retained`` gives their absolute offset).
    """

    def __init__(self, engine: Optional[VetEngine] = None, *, window: int,
                 stride: int = 1, capacity: Optional[int] = None,
                 history: Optional[int] = None):
        window = int(window)
        stride = int(stride)
        if window < 2:
            raise ValueError(f"window must cover >= 2 records, got {window}")
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        capacity = int(capacity) if capacity is not None else 4 * window
        if capacity < window:
            raise ValueError(
                f"capacity ({capacity}) must hold at least one window "
                f"({window} records)")
        if history is not None:
            history = int(history)
            if history < 1:
                raise ValueError(
                    f"history must retain >= 1 window row, got {history}")
        self.engine = engine if engine is not None else default_engine("cuda")
        self.window = window
        self.stride = stride
        self.capacity = capacity
        self.history = history
        self._ring = np.zeros(capacity, dtype=np.float64)
        self._total = 0  # records ever appended (logical stream length)
        self._vetted = 0  # windows whose rows are current in the result arrays
        self._epoch = 0
        self._fp = hashlib.blake2b(digest_size=16)
        self._ticks = 0
        self._vetted_rows = 0
        self._reused_rows = 0
        self._evicted_rows = 0
        self._last: Optional[BatchVetResult] = None
        # Accumulated per-window rows.  Window ``k`` lives at physical slot
        # ``k - _phys_base``; rows below ``_row_base`` are evicted (bounded
        # history) and never re-exposed.  Results are frozen *views* of these
        # arrays — O(delta) per tick, not O(windows-so-far) copies — so rows
        # already exposed to callers are never written again: a rewind
        # (amend/invalidate) below the exposed watermark, growth past the
        # physical capacity, and history compaction all reallocate fresh row
        # storage first (copy-on-write), leaving outstanding snapshots
        # aliasing the detached buffers.
        self._rows = {
            "vet": np.empty(_GROW), "ei": np.empty(_GROW),
            "oc": np.empty(_GROW), "pr": np.empty(_GROW),
            "t": np.empty(_GROW, dtype=np.int32),
            "n": np.empty(_GROW, dtype=np.int64),
        }
        self._phys_base = 0  # absolute window index stored at physical slot 0
        self._row_base = 0  # first retained (non-evicted) window index
        self._exposed = 0  # absolute window count handed out in some result
        self._dirty_low: Optional[int] = None  # lowest re-vetted exposed row

    def __repr__(self) -> str:
        return (f"VetStream(window={self.window}, stride={self.stride}, "
                f"capacity={self.capacity}, records={self._total}, "
                f"windows={self.complete_windows}, epoch={self._epoch})")

    # ------------------------------------------------------------ geometry
    @property
    def total_records(self) -> int:
        """Records ever appended (logical stream length)."""
        return self._total

    @property
    def complete_windows(self) -> int:
        """Windows fully covered by the stream so far."""
        if self._total < self.window:
            return 0
        return (self._total - self.window) // self.stride + 1

    @property
    def pending_windows(self) -> int:
        """Complete windows not yet vetted (what the next drain would take)."""
        return max(0, self.complete_windows - self._vetted)

    @property
    def headroom(self) -> int:
        """Records appendable before an unvetted window leaves the ring.

        When this reaches 0, the next append may overwrite records of a
        window that has not been vetted yet (a later ``tick`` then raises);
        ``feed`` — and ``repro_torch.fleet.VetMux.feed`` — tick exactly when it is
        exhausted.
        """
        return self._vetted * self.stride + self.capacity - self._total

    @property
    def first_retained(self) -> int:
        """Absolute index of the oldest window still held in the result rows
        (0 unless a ``history`` cap evicted older rows)."""
        return self._row_base

    @property
    def stats(self) -> StreamStats:
        return StreamStats(ticks=self._ticks, records=self._total,
                           windows=self.complete_windows,
                           vetted=self._vetted_rows, reused=self._reused_rows,
                           epoch=self._epoch, evicted=self._evicted_rows)

    @property
    def fingerprint(self) -> str:
        """Rolling content fingerprint of the append/amend history."""
        return self._fp.hexdigest()

    def resident(self) -> np.ndarray:
        """Copy of the retained record suffix, in stream order."""
        lo = max(0, self._total - self.capacity)
        return self._ring[np.arange(lo, self._total) % self.capacity]

    def latest(self, n: int) -> np.ndarray:
        """Copy of the last ``min(n, resident)`` records, in stream order."""
        lo = max(0, self._total - min(int(n), self.capacity))
        return self._ring[np.arange(lo, self._total) % self.capacity]

    # ------------------------------------------------------------- writing
    def _write(self, arr: np.ndarray, pos0: int) -> None:
        """Write ``arr`` (len <= capacity) at logical position ``pos0``."""
        s = pos0 % self.capacity
        k = min(arr.size, self.capacity - s)
        self._ring[s:s + k] = arr[:k]
        if arr.size > k:
            self._ring[:arr.size - k] = arr[k:]

    @staticmethod
    def _coerce(times) -> np.ndarray:
        arr = np.asarray(times, dtype=np.float64)
        if arr.ndim > 1:
            raise ValueError(
                f"append expects a 1-D chunk of record times, got shape "
                f"{arr.shape}")
        return np.ascontiguousarray(np.atleast_1d(arr))

    def append(self, times) -> int:
        """Append a chunk of record times; O(chunk).  Returns records added.

        The raw primitive: no safety ticks — between two ``tick()`` calls the
        caller may append at most ``capacity - window - stride + 1`` records
        before an unvetted window falls out of the ring (``tick`` then
        raises).  Use ``feed`` to have the stream manage that budget itself.

        Args:
            times: 1-D chunk of record times (seconds).

        Returns:
            Number of records appended (the chunk size).

        Raises:
            ValueError: on a multi-dimensional chunk.

        Example::

            >>> eng = VetEngine("numpy", buckets=64)
            >>> s = VetStream(eng, window=8, stride=4, capacity=32)
            >>> s.append(np.linspace(1e-3, 2e-3, 16))
            16
            >>> s.pending_windows      # windows 0..2 complete, unvetted
            3
        """
        arr = self._coerce(times)
        if arr.size == 0:
            return 0
        self._fp.update(arr.tobytes())  # rolling: O(chunk), never the buffer
        if arr.size >= self.capacity:
            self._write(arr[-self.capacity:], self._total + arr.size
                        - self.capacity)
        else:
            self._write(arr, self._total)
        self._total += arr.size
        return arr.size

    def feed(self, times, *, on_pressure=None) -> int:
        """Append an arbitrarily large chunk, ticking only when forced.

        Splits the chunk so that no unvetted window can fall out of the ring:
        a mid-feed ``tick()`` happens exactly when the remaining append
        budget is exhausted (its result rows are retained as usual — the
        next ``tick()`` returns them without re-dispatch).  Ingest therefore
        stays O(chunk) unless overrun protection forces estimation work that
        any later ``tick()`` would have had to pay anyway.

        ``on_pressure`` replaces the forced ``self.tick()`` for consumers
        that must do more than vet when the budget runs out — the fleet mux
        ticks the *whole fleet* coalesced, ``OnlineVet`` folds each forced
        tick's rows into its EMA before eviction can drop them.  The hook
        must advance the vetted watermark (tick this stream somehow) or the
        feed cannot make progress.

        Args:
            times: 1-D chunk of record times, arbitrarily large.
            on_pressure: zero-arg hook run in place of the forced tick.

        Returns:
            Number of records appended (the chunk size).

        Raises:
            RuntimeError: when ``on_pressure`` fails to vet this stream.

        Example::

            >>> eng = VetEngine("numpy", buckets=64)
            >>> s = VetStream(eng, window=8, stride=4, capacity=16)
            >>> s.feed(np.linspace(1e-3, 2e-3, 100))   # 6x the ring
            100
            >>> s.tick().workers       # no window was ever lost
            24
        """
        on_pressure = self.tick if on_pressure is None else on_pressure
        arr = self._coerce(times)
        pos = 0
        while pos < arr.size:
            # Records we may still append before the first unvetted window's
            # start (vetted * stride) would leave the resident suffix.
            budget = self.headroom
            if budget <= 0:
                on_pressure()  # advances _vetted: budget >= capacity-window+1
                if self.headroom <= 0:
                    raise RuntimeError(
                        "feed on_pressure hook did not vet this stream; "
                        "the hook must tick it (directly or via its mux)")
                continue
            pos += self.append(arr[pos:pos + budget])
        return arr.size

    # ------------------------------------------------------------- ticking
    def _gather(self, starts: np.ndarray) -> np.ndarray:
        idx = (starts[:, None] + np.arange(self.window)[None, :]) \
            % self.capacity
        return self._ring[idx]

    def drain(self, max_windows: Optional[int] = None) -> Optional[StreamDelta]:
        """Gather the unvetted complete-window delta; side-effect free.

        Returns ``None`` when no unvetted complete window exists.  With
        ``max_windows`` only the oldest that many pending windows are taken
        (partial service under a mux tick budget); windows are always drained
        in order, so repeated partial drains cover the stream exactly once.

        Raises ``ValueError`` if the oldest unvetted window's records were
        already overwritten in the ring (appends outran ``capacity``).

        Example::

            >>> eng = VetEngine("numpy", buckets=64)
            >>> s = VetStream(eng, window=8, stride=4, capacity=32)
            >>> _ = s.append(np.linspace(1e-3, 2e-3, 16))
            >>> delta = s.drain()
            >>> (delta.start, delta.count, delta.matrix.shape)
            (0, 3, (3, 8))
            >>> s.pending_windows      # side-effect free: still pending
            3
        """
        n_new = self.pending_windows
        if n_new <= 0:
            return None
        if max_windows is not None:
            n_new = min(n_new, int(max_windows))
            if n_new <= 0:
                return None
        first_start = self._vetted * self.stride
        if first_start < self._total - self.capacity:
            raise ValueError(
                f"stream overran the ring buffer: window "
                f"{self._vetted} starts at record {first_start} but only "
                f"records [{self._total - self.capacity}, {self._total}) "
                f"are resident; tick() more often or raise capacity "
                f"({self.capacity})")
        starts = np.arange(self._vetted, self._vetted + n_new,
                           dtype=np.int64) * self.stride
        # Keyed on the rolling fingerprint + window span + epoch — the
        # delta is a pure function of the (content-hashed) append/amend
        # history, so no per-delta matrix re-hash is needed for a replay
        # of the same stream to hit the engine cache.
        key = ("stream", self.window, self.stride, self._vetted,
               self._vetted + n_new, self._epoch, self._fp.hexdigest())
        with _span(self.engine.tracer, "stream.drain",
                   tid=self.engine.trace_tid, windows=n_new):
            matrix = self._gather(starts)
        return StreamDelta(start=self._vetted, count=n_new,
                           matrix=matrix, key=key, epoch=self._epoch)

    def drain_ring(self, max_windows: Optional[int] = None) \
            -> Optional[RingDelta]:
        """``drain`` for the fused engine path: ring-relative bounds, no
        gather matrix.

        Returns the contiguous stream-order span covering the pending
        windows plus their span-relative starts (a ``RingDelta``) — memory
        O(span), where ``drain`` materializes O(windows x window).  Same
        watermark/overrun semantics as ``drain``; the cache key differs by
        tag only (the fused kernel's rows are not bitwise the gather
        batch's, so the two paths must not share cache entries).

        Example::

            >>> eng = VetEngine("numpy", buckets=64)
            >>> s = VetStream(eng, window=8, stride=4, capacity=32)
            >>> _ = s.append(np.linspace(1e-3, 2e-3, 16))
            >>> d = s.drain_ring()
            >>> (d.start, d.count, d.arena.shape, d.starts.tolist())
            (0, 3, (16,), [0, 4, 8])
        """
        n_new = self.pending_windows
        if n_new <= 0:
            return None
        if max_windows is not None:
            n_new = min(n_new, int(max_windows))
            if n_new <= 0:
                return None
        base = self._vetted * self.stride
        if base < self._total - self.capacity:
            raise ValueError(
                f"stream overran the ring buffer: window "
                f"{self._vetted} starts at record {base} but only "
                f"records [{self._total - self.capacity}, {self._total}) "
                f"are resident; tick() more often or raise capacity "
                f"({self.capacity})")
        end = (self._vetted + n_new - 1) * self.stride + self.window
        with _span(self.engine.tracer, "stream.drain",
                   tid=self.engine.trace_tid, windows=n_new, ring=True):
            arena = self._ring[np.arange(base, end) % self.capacity]
        starts = np.arange(n_new, dtype=np.int64) * self.stride
        key = ("fusedring", self.window, self.stride, self._vetted,
               self._vetted + n_new, self._epoch, self._fp.hexdigest())
        return RingDelta(start=self._vetted, count=n_new, arena=arena,
                         starts=starts, window=self.window, key=key,
                         epoch=self._epoch)

    def commit(self, delta: StreamDelta, rows: BatchVetResult) -> None:
        """Splice externally computed ``rows`` for ``delta`` into the stream.

        ``rows`` must be the engine's result for exactly ``delta.matrix``
        (the mux computes it inside a coalesced dispatch and hands each
        stream its slice).  Deltas commit in order: ``delta.start`` must
        equal the current vetted watermark, so a delta drained before an
        intervening ``commit``/``amend``/``invalidate`` is rejected instead
        of silently splicing stale rows.

        Args:
            delta: the ``StreamDelta`` returned by ``drain``.
            rows: the engine's ``BatchVetResult`` for ``delta.matrix``.

        Raises:
            ValueError: stale delta (watermark or epoch mismatch) or a row
                count that does not match the delta.

        Example::

            >>> eng = VetEngine("numpy", buckets=64)
            >>> s = VetStream(eng, window=8, stride=4, capacity=32)
            >>> _ = s.append(np.linspace(1e-3, 2e-3, 16))
            >>> delta = s.drain()
            >>> s.commit(delta, eng.vet_batch(delta.matrix))
            >>> s.collect().workers    # rows spliced, watermark advanced
            3
        """
        if delta.start != self._vetted:
            raise ValueError(
                f"stale delta: starts at window {delta.start} but the stream "
                f"has vetted {self._vetted} windows — drain after every "
                f"commit/amend/invalidate")
        if delta.epoch != self._epoch:
            # An amend of a *pending* window leaves the vetted watermark
            # alone, so the start check above cannot catch a delta gathered
            # before the mutation — the epoch does.
            raise ValueError(
                f"stale delta: drained at epoch {delta.epoch} but the stream "
                f"was amended/invalidated since (epoch {self._epoch}) — "
                f"re-drain to pick up the mutated records")
        if rows.workers != delta.count:
            raise ValueError(
                f"delta covers {delta.count} windows but got {rows.workers} "
                f"result rows")
        self._reused_rows += self._vetted
        self._vetted_rows += delta.count
        with _span(self.engine.tracer, "stream.commit",
                   tid=self.engine.trace_tid, windows=delta.count):
            self._splice(delta.start, rows)
            self._vetted = delta.start + delta.count
            if (self.history is not None
                    and self._vetted - self._row_base > self.history):
                evict_to = self._vetted - self.history
                self._evicted_rows += evict_to - self._row_base
                self._row_base = evict_to
            self._last = None

    def collect(self) -> Optional[BatchVetResult]:
        """Result over the retained vetted windows (frozen views), or ``None``
        while no window has been vetted.  Row ``j`` is window
        ``first_retained + j``.  Repeated calls between commits return the
        same object.
        """
        n_rows = self._vetted - self._row_base
        if n_rows <= 0:
            return None
        if self._last is not None:
            return self._last
        with _span(self.engine.tracer, "stream.collect",
                   tid=self.engine.trace_tid, windows=n_rows):
            lo = self._row_base - self._phys_base
            fields = {}
            for name in ("vet", "ei", "oc", "pr", "t", "n"):
                v = self._rows[name][lo:lo + n_rows]
                v.flags.writeable = False  # restricts the view, not the base
                fields[name] = v
            res = BatchVetResult(**fields)
            self._exposed = max(self._exposed, self._vetted)
            self._last = res
            return res

    def tick(self) -> Optional[BatchVetResult]:
        """Vet the windows that became complete since the last tick.

        Returns a ``BatchVetResult`` over all retained complete windows of
        the stream so far (row ``j`` = window ``first_retained + j``; with no
        ``history`` cap that is every window), or ``None`` while no window is
        complete yet.  Only the delta since the last tick is dispatched to
        the engine; earlier rows are reused.  A no-op tick (no new windows)
        returns the previous result object itself.

        Raises ``ValueError`` if an unvetted window's records were already
        overwritten in the ring (appends outran ``capacity`` between ticks).

        Example::

            >>> eng = VetEngine("numpy", buckets=64)
            >>> s = VetStream(eng, window=8, stride=4, capacity=32)
            >>> _ = s.append(np.linspace(1e-3, 2e-3, 16))
            >>> res = s.tick()         # one dispatch over the 3-window delta
            >>> res.workers
            3
            >>> s.tick() is res        # no new records: zero dispatches
            True
        """
        self._ticks += 1
        if self.complete_windows == 0:
            return None
        fused = self.engine.fused_supported(self.window)
        delta = self.drain_ring() if fused else self.drain()
        if delta is None:
            if self._last is not None:
                self._reused_rows += self.complete_windows
                return self._last
            return self.collect()
        n_new = delta.count
        if fused:
            # Fused path: hand the engine ring-relative bounds — one
            # launch, staged memory O(span); row padding happens inside
            # the kernel wrapper.
            lengths = np.full(n_new, self.window, dtype=np.int64)
            rows = self.engine._memo(
                delta.key, lambda: self.engine._vet_arena_impl(
                    delta.arena, delta.starts, lengths))
        else:
            matrix, _ = self.engine.pad_rows_pow2(delta.matrix)
            rows = self.engine._memo(
                delta.key, lambda: self.engine._vet_batch_impl(matrix))
        if rows.workers > n_new:
            rows = BatchVetResult(*(a[:n_new] for a in rows))
        self.commit(delta, rows)
        return self.collect()

    def _splice(self, at: int, delta: BatchVetResult) -> None:
        """Write ``delta`` rows for windows ``[at, at + delta.workers)``."""
        need_phys = at + delta.workers - self._phys_base
        cap = self._rows["vet"].size
        # Copy-on-write: rows < _exposed alias results already handed out;
        # a rewind (amend/invalidate) about to overwrite them detaches the
        # old storage so those snapshots stay pristine.  Growth past the
        # physical capacity reallocates anyway — and compacts evicted
        # history rows away, keeping storage O(retained + delta) — which
        # detaches just the same.
        if need_phys > cap or at < self._exposed:
            new_base = min(self._row_base, at)
            new_cap = max(2 * (at + delta.workers - new_base), _GROW)
            old_lo = new_base - self._phys_base
            keep = at - new_base
            for name, arr in self._rows.items():
                grown = np.empty(new_cap, dtype=arr.dtype)
                grown[:keep] = arr[old_lo:old_lo + keep]
                self._rows[name] = grown
            self._phys_base = new_base
            self._exposed = min(self._exposed, at)
        lo = at - self._phys_base
        hi = lo + delta.workers
        for name in ("vet", "ei", "oc", "pr", "t"):
            self._rows[name][lo:hi] = getattr(delta, name)
        self._rows["n"][lo:hi] = self.window

    # -------------------------------------------------------- invalidation
    def amend(self, start: int, values) -> None:
        """Rewrite resident records ``[start, start + len(values))`` in place.

        The targeted invalidation hook: a profiler revising recently observed
        record times (clock correction, late attribution) amends them here
        instead of rebuilding the stream.  The rolling fingerprint is re-keyed
        (epoch tag), and the next ``tick()`` re-vets exactly the already-vetted
        windows from the first one covering ``start`` — never the whole
        history — so no stale cached row survives.  Rows already evicted by a
        ``history`` cap are gone and stay gone (nothing stale can be served
        from them).  Amending records that are no longer resident (or whose
        re-vettable windows already left the ring) raises.

        Args:
            start: absolute stream position of the first rewritten record.
            values: the replacement record times.

        Raises:
            ValueError: a range outside the appended stream or before the
                resident suffix, or an affected vetted window that is no
                longer fully resident.

        Example::

            >>> eng = VetEngine("numpy", buckets=64)
            >>> s = VetStream(eng, window=8, stride=8, capacity=32)
            >>> _ = s.append(np.linspace(1e-3, 2e-3, 16))
            >>> _ = s.tick()
            >>> s.amend(12, [5e-3])        # record 12 sits in window 1 only
            >>> s.pending_windows          # exactly that window re-vets
            1
            >>> s.tick().workers, s.consume_rewind()
            (2, 1)
        """
        vals = np.atleast_1d(np.asarray(values, dtype=np.float64)).ravel()
        start = int(start)
        end = start + vals.size
        if vals.size == 0:
            return
        if start < 0 or end > self._total:
            raise ValueError(
                f"amend range [{start}, {end}) outside the appended stream "
                f"[0, {self._total})")
        if start < self._total - self.capacity:
            raise ValueError(
                f"amend range [{start}, {end}) starts before the resident "
                f"suffix [{self._total - self.capacity}, {self._total})")
        # Window span that sees any amended record, clamped to the bounded
        # history's retained rows (evicted rows cannot be recomputed —
        # when every affected row is already evicted, the ring content
        # still re-keys but no retained row needs re-vetting).
        first_affected = (0 if start < self.window
                          else (start - self.window) // self.stride + 1)
        last_affected = min(self._vetted - 1, (end - 1) // self.stride)
        redo = last_affected >= self._row_base
        if redo:
            first_redo = max(first_affected, self._row_base)
            if first_redo < self._vetted:
                # Those rows must be recomputed — their windows must still
                # be fully resident.
                lo_resident = max(0, self._total - self.capacity)
                if first_redo * self.stride < lo_resident:
                    raise ValueError(
                        f"amend at record {start} affects window "
                        f"{first_redo}, which is no longer fully resident; "
                        f"raise capacity ({self.capacity}) to amend that far "
                        f"back")
        self._write(vals, start)
        self._epoch += 1
        self._fp.update(b"|amend|")
        self._fp.update(np.int64(start).tobytes())
        self._fp.update(vals.tobytes())
        if redo:
            self._mark_rewound(first_redo)

    def invalidate(self) -> int:
        """Blanket hook: the ring was mutated outside ``append``/``amend``.

        Bumps the epoch, folds the *current* resident content into the
        rolling fingerprint (so future cache keys reflect what is actually in
        the ring, not the stale append history), and marks every window still
        fully resident (and still retained by the ``history`` cap) for
        re-vetting on the next ``tick()``.  Rows for windows that already
        left the ring keep their last computed values — they cannot be
        recomputed from evicted records.  Returns the number of window rows
        scheduled for re-vetting.

        Example::

            >>> eng = VetEngine("numpy", buckets=64)
            >>> s = VetStream(eng, window=8, stride=4, capacity=32)
            >>> _ = s.append(np.linspace(1e-3, 2e-3, 16))
            >>> _ = s.tick()
            >>> s.invalidate()         # "I changed the ring under you"
            3
            >>> s.tick().workers       # every resident window re-vetted
            3
        """
        self._epoch += 1
        self._fp.update(b"|invalidate|")
        self._fp.update(self.resident().tobytes())
        lo_resident = max(0, self._total - self.capacity)
        first_resident = -(-lo_resident // self.stride)  # ceil div
        first_redo = max(first_resident, self._row_base)
        dropped = max(0, self._vetted - first_redo)
        self._mark_rewound(first_redo)
        return dropped

    def _mark_rewound(self, first_dirty: int) -> None:
        if first_dirty < self._vetted:
            self._dirty_low = (first_dirty if self._dirty_low is None
                               else min(self._dirty_low, first_dirty))
        self._vetted = min(self._vetted, first_dirty)
        self._last = None

    # ------------------------------------------------------- checkpointing
    def state_dict(self) -> dict:
        """Pickle-safe snapshot of the stream: ring, watermarks, retained
        result rows, counters, and the fingerprint *digest*.

        The transport layer checkpoints shard state with this so a killed
        worker process resumes mid-job.  The
        rolling blake2b object itself cannot cross a process boundary (hash
        objects do not pickle); the snapshot carries its hexdigest and
        ``from_state`` chains a fresh rolling hash off it, so every
        post-restore cache key is distinct from every key the original
        stream ever issued — a restored stream can never collide with a
        stale engine-cache entry.
        """
        lo = self._row_base - self._phys_base
        n = self._vetted - self._phys_base
        return {
            "window": self.window, "stride": self.stride,
            "capacity": self.capacity, "history": self.history,
            "ring": self._ring.copy(), "total": self._total,
            "vetted": self._vetted, "epoch": self._epoch,
            "fingerprint": self.fingerprint,
            "row_base": self._row_base,
            "rows": {name: np.array(arr[lo:n])
                     for name, arr in self._rows.items()},
            "dirty_low": self._dirty_low,
            "stats": (self._ticks, self._vetted_rows, self._reused_rows,
                      self._evicted_rows),
        }

    @classmethod
    def from_state(cls, engine: Optional[VetEngine], state: dict) \
            -> "VetStream":
        """Rebuild a stream from a ``state_dict`` snapshot, bound to
        ``engine`` (typically a fresh per-process engine — caches rebuild
        on demand).

        The restored stream continues exactly where the snapshot stopped:
        same pending windows, same retained rows (``collect()`` is bitwise
        the snapshot's), same vetted watermark — so committed windows are
        never re-vetted after a resume.
        """
        s = cls(engine, window=state["window"], stride=state["stride"],
                capacity=state["capacity"], history=state["history"])
        s._ring[:] = state["ring"]
        s._total = state["total"]
        s._vetted = state["vetted"]
        s._epoch = state["epoch"]
        # Chain the fresh rolling hash off the recorded digest (see
        # state_dict): same prefix => same chain, but no raw-hash-state
        # revival is needed.
        s._fp.update(b"|resume|")
        s._fp.update(state["fingerprint"].encode())
        s._row_base = s._phys_base = state["row_base"]
        retained = s._vetted - s._row_base
        cap = max(_GROW, 2 * retained)
        for name, arr in state["rows"].items():
            grown = np.empty(cap, dtype=s._rows[name].dtype)
            grown[:retained] = arr
            s._rows[name] = grown
        # Conservative: treat every restored row as already handed out, so
        # any rewind over them copies-on-write instead of mutating storage
        # the pre-crash process may have exposed.
        s._exposed = s._vetted
        s._dirty_low = state["dirty_low"]
        (s._ticks, s._vetted_rows, s._reused_rows,
         s._evicted_rows) = state["stats"]
        return s

    def consume_rewind(self) -> Optional[int]:
        """Lowest row index re-vetted by ``amend``/``invalidate`` since the
        last call, or ``None``.  Incremental consumers that fold rows exactly
        once (e.g. ``OnlineVet``'s EMA) poll this to know which already-
        consumed rows were recomputed and re-fold from there; reading it
        clears the watermark.
        """
        low, self._dirty_low = self._dirty_low, None
        return low
