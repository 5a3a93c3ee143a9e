"""VetEngine: one estimation API, three interchangeable backends.

The port of ``repro.engine.engine``.  Backends (``VetEngine(backend=...)``):

- ``numpy`` — the scalar per-row oracle: a host loop of the port's
  ``core.vet.vet_task``, one call per row, always on the CPU.
- ``torch`` — the batched plain PyTorch path: the whole (rows, window)
  matrix goes through ``core.vet.vet_pipeline`` in one call on the resolved
  device (the batch dimension written out where the reference used
  ``jax.vmap``).
- ``cuda`` — the same batched path with the change-point scan routed
  through the CUDA kernel (``kernels.changepoint``), and the windowed /
  stream / mux entry points routed through the fused window-vet kernel
  (``kernels.windowvet``): one launch per ragged window set.  On a CPU
  device the kernel wrappers run their plain versions.

The device is resolved lazily by ``kernels.runtime`` (explicit ``device=``,
else ``REPRO_TORCH_DEVICE``, else ``cuda``): constructing an engine touches
no CUDA state, and the first dispatch on a ``cuda`` device without a card
raises.  The public API takes and returns numpy host arrays; every entry
point is memoized in a bounded LRU cache keyed on per-buffer content
fingerprints, with frozen results, exactly as the reference.

``fused`` defaults to on for the ``cuda`` backend only.  ``fused=True`` on
the ``torch`` backend runs the fused path through the kernel's plain
version, which keeps dispatch counts comparable with the ``cuda`` backend.
The fused gate also requires every window to fit the kernel
(``max_len <= windowvet.MAX_LMAX``); longer windows keep the gather path.
"""

from __future__ import annotations

import collections
import functools
import hashlib
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.vet import VetResult, vet_pipeline, vet_task
from ..kernels import runtime
from ..kernels.changepoint.ops import changepoint_cuda
from ..kernels.windowvet.ops import MAX_LMAX, fused_window_vet, staged_bytes
from ..obs.trace import span as _span

__all__ = [
    "BACKENDS",
    "BatchVetResult",
    "CacheInfo",
    "VetEngine",
    "default_engine",
]

BACKENDS = ("numpy", "torch", "cuda")


class CacheInfo(NamedTuple):
    """Result-cache counters (``VetEngine.cache_info()``)."""

    hits: int
    misses: int
    size: int
    max_size: int


class BatchVetResult(NamedTuple):
    """Per-worker vet diagnostics for a batch of profiles (host arrays)."""

    vet: np.ndarray  # (W,) PR / EI per worker
    ei: np.ndarray  # (W,) estimated ideal cost (seconds)
    oc: np.ndarray  # (W,) estimated overhead cost (seconds)
    pr: np.ndarray  # (W,) profiled real cost == EI + OC
    t: np.ndarray  # (W,) change-point (1-indexed record-rank prefix size)
    n: np.ndarray  # (W,) records per profile

    @property
    def workers(self) -> int:
        return int(self.vet.shape[0])

    @property
    def vet_job(self) -> float:
        """vet_job = mean of per-task vet scores (paper §4.4)."""
        return float(self.vet.mean())

    def task(self, i: int) -> VetResult:
        """The i-th worker's result in the scalar ``VetResult`` container."""
        return VetResult(
            vet=torch.tensor(self.vet[i], dtype=torch.float32),
            ei=torch.tensor(self.ei[i], dtype=torch.float32),
            oc=torch.tensor(self.oc[i], dtype=torch.float32),
            pr=torch.tensor(self.pr[i], dtype=torch.float32),
            t=torch.tensor(self.t[i], dtype=torch.int32),
            n=int(self.n[i]),
        )


class VetEngine:
    """Batched record-times -> change-point -> extrapolation -> (EI, OC, vet).

    Parameters mirror ``vet_task``: ``omega`` (probing window), ``buckets``
    (curve bucketing; auto-disabled when a profile has < 4*buckets records)
    and ``cut_space`` ("log" framework default / "raw" paper-literal).
    ``backend`` picks the execution path (module docstring); ``device`` the
    torch device of the ``torch``/``cuda`` backends, resolved on first
    dispatch (``None``: the ``kernels.runtime`` policy).  ``fused`` routes
    the windowed entry points (``vet_sliding``/``vet_windows`` and the
    stream/mux tick paths) through the fused window-vet kernel; ``None``
    enables it exactly for ``backend="cuda"``.  ``cache_size`` bounds the
    memoized result cache (0 disables it).
    """

    def __init__(
        self,
        backend: str = "cuda",
        *,
        omega: int = 3,
        buckets: Optional[int] = 1000,
        cut_space: str = "log",
        device=None,
        fused: Optional[bool] = None,
        cache_size: int = 128,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if cut_space not in ("raw", "log"):
            raise ValueError(f"cut_space must be 'raw' or 'log', got {cut_space!r}")
        self.backend = backend
        self.omega = omega
        self.buckets = buckets
        self.cut_space = cut_space
        # Unresolved: the device policy runs on the first dispatch, never at
        # construction (workers build engines right after spawn).
        self._device_arg = device
        self._device: Optional[torch.device] = None
        self.fused = (backend == "cuda") if fused is None else bool(fused)
        # Backend dispatches ever issued (one per _vet_batch_impl /
        # _vet_arena_impl call, cache hits excluded): a mux tick is one
        # dispatch per shape bucket (one total on the fused path).
        self.dispatches = 0
        # Bytes staged for the backend across those dispatches: the gather
        # matrices on the batch path, the O(arena + rows) launch inputs on
        # the fused path (the reference's ledger formulas).
        self.dispatch_bytes = 0
        # Memoized results: fingerprint(buffer) + params -> BatchVetResult.
        self._cache_size = int(cache_size)
        self._cache: "collections.OrderedDict[tuple, BatchVetResult]" = (
            collections.OrderedDict()
        )
        self._cache_hits = 0
        self._cache_misses = 0
        # Observability seam (repro_torch.obs): every backend dispatch
        # records an ``engine.dispatch`` span when a tracer is attached.
        self.tracer = None
        self.trace_tid = 0
        self._seen_shapes: set = set()

    def set_tracer(self, tracer, tid: int = 0) -> None:
        """Attach (or detach, with ``None``) a ``repro_torch.obs.Tracer``;
        spans from this engine land on lane ``tid``."""
        self.tracer = tracer
        self.trace_tid = int(tid)

    def _dispatch_cold(self, kind: str, shape) -> bool:
        """First time this engine dispatches ``shape`` on a batched backend."""
        key = (kind, tuple(shape))
        if key in self._seen_shapes:
            return False
        self._seen_shapes.add(key)
        return self.backend != "numpy"

    def __repr__(self) -> str:
        return (f"VetEngine(backend={self.backend!r}, omega={self.omega}, "
                f"buckets={self.buckets}, cut_space={self.cut_space!r})")

    @property
    def device(self) -> torch.device:
        """Resolved device (the ``numpy`` backend always runs on the CPU).
        Resolution does not touch CUDA; ``_require_device`` checks it."""
        if self._device is None:
            self._device = (torch.device("cpu") if self.backend == "numpy"
                            else runtime.resolve_device(self._device_arg))
        return self._device

    def _require_device(self) -> torch.device:
        return runtime.require_device(self.device)

    def clone(self) -> "VetEngine":
        """A fresh engine with this engine's configuration and nothing else
        (no result cache, no counters).  The unresolved ``device`` argument
        is forwarded, so a clone built in another process resolves its own
        policy."""
        return VetEngine(self.backend, omega=self.omega, buckets=self.buckets,
                         cut_space=self.cut_space, device=self._device_arg,
                         fused=self.fused, cache_size=self._cache_size)

    # ------------------------------------------------------------- backends
    def _numpy_batch(self, matrix: np.ndarray) -> BatchVetResult:
        # The scalar per-row oracle: vet_task per row, on the host.
        results = [
            vet_task(row, omega=self.omega, buckets=self.buckets,
                     cut_space=self.cut_space)
            for row in matrix
        ]
        return BatchVetResult(
            vet=np.asarray([float(r.vet) for r in results]),
            ei=np.asarray([float(r.ei) for r in results]),
            oc=np.asarray([float(r.oc) for r in results]),
            pr=np.asarray([float(r.pr) for r in results]),
            t=np.asarray([int(r.t) for r in results], dtype=np.int32),
            n=np.asarray([r.n for r in results], dtype=np.int64),
        )

    def _torch_batch(self, m: np.ndarray) -> BatchVetResult:
        dev = self._require_device()
        x = torch.from_numpy(np.ascontiguousarray(m, dtype=np.float32)).to(dev)
        cp_fn = changepoint_cuda if self.backend == "cuda" else None
        vet, ei, oc, pr, t = vet_pipeline(
            x, omega=self.omega, buckets=self.buckets,
            cut_space=self.cut_space, changepoint_fn=cp_fn)
        out = torch.stack([vet, ei, oc, pr]).cpu().numpy().astype(np.float64)
        return BatchVetResult(
            vet=out[0], ei=out[1], oc=out[2], pr=out[3],
            t=t.cpu().numpy().astype(np.int32),
            n=np.full(m.shape[0], m.shape[1], dtype=np.int64),
        )

    # -------------------------------------------------------------- caching
    @staticmethod
    def _digest(a: np.ndarray) -> str:
        """Content fingerprint of one buffer (shape + dtype + bytes)."""
        a = np.ascontiguousarray(a)
        h = hashlib.blake2b(digest_size=16)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
        return h.hexdigest()

    def _key(self, tag: str, arrays: Sequence[np.ndarray], *params) -> tuple:
        """Cache key: per-buffer content fingerprints + call params.

        Each input buffer is fingerprinted *separately* (a tuple of digests,
        not one rolled-up hash) so ``invalidate(buffer)`` can find every
        cached result that was computed from a given buffer, including
        multi-buffer entries (``vet_many`` / ``vet_windows``).  The engine
        config (backend/omega/buckets/cut_space) is fixed per instance and
        the cache is per instance, so it needs no key bits.
        """
        return (tag, *params, tuple(self._digest(a) for a in arrays))

    def invalidate(self, buffer) -> int:
        """Evict every cached result computed from ``buffer``; return count.

        The cache is keyed on buffer *content*, so an in-place mutation
        already changes the key and can never serve a stale hit — but the
        stale entries for the pre-mutation content stay resident until LRU
        pressure ages them out.  ``invalidate`` drops them eagerly: call it
        with the buffer (pre- or post-mutation content both work if you hold
        the respective arrays; matching is by content) when a consumer
        explicitly mutates a profile it previously vetted.  Streams built on
        this engine (``repro.engine.stream.VetStream``) key their incremental
        dispatches on an epoch-tagged rolling fingerprint instead and expose
        their own ``invalidate()``/``amend()`` hooks.

        Args:
            buffer: the mutated array (pre- or post-mutation content).

        Returns:
            Number of cache entries evicted.

        Example::

            >>> eng = VetEngine("numpy", buckets=64)
            >>> buf = np.linspace(1e-3, 2e-3, 16)
            >>> _ = eng.vet_batch(buf)
            >>> eng.invalidate(buf)    # evicts the entry computed from buf
            1
        """
        arr = np.asarray(buffer)
        digests = {self._digest(arr)}
        # The canonical forms the public entry points hash: vet_batch's
        # atleast_2d float64 matrix, and the 1-D float64 stream/profile view
        # used by vet_many / vet_sliding / vet_windows.
        as64 = np.asarray(buffer, dtype=np.float64)
        digests.add(self._digest(np.atleast_2d(as64)))
        if as64.ndim <= 1:
            digests.add(self._digest(np.atleast_1d(as64).ravel()))
        dead = [k for k in self._cache
                if digests.intersection(k[-1] if isinstance(k[-1], tuple)
                                        else (k[-1],))]
        for k in dead:
            del self._cache[k]
        return len(dead)

    @staticmethod
    def _freeze(res: BatchVetResult) -> BatchVetResult:
        # Results are always read-only — cache hits alias the stored arrays,
        # and mutability must not depend on the engine's cache config.
        for a in res:
            if isinstance(a, np.ndarray):
                a.flags.writeable = False
        return res

    def _memo(self, key: tuple, compute: Callable[[], BatchVetResult]):
        if self._cache_size <= 0:
            return self._freeze(compute())
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            self._cache_hits += 1
            return hit
        self._cache_misses += 1
        res = self._freeze(compute())
        self._cache[key] = res
        while len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)
        return res

    def cache_info(self) -> CacheInfo:
        """Result-cache counters (hits/misses/size/max_size).

        Example::

            >>> eng = VetEngine("numpy", buckets=64)
            >>> times = np.linspace(1e-3, 2e-3, 16)
            >>> _ = eng.vet_batch(times)       # miss: computes
            >>> _ = eng.vet_batch(times)       # hit: served from cache
            >>> ci = eng.cache_info()
            >>> (ci.hits, ci.misses, ci.size)
            (1, 1, 1)
        """
        return CacheInfo(hits=self._cache_hits, misses=self._cache_misses,
                         size=len(self._cache), max_size=self._cache_size)

    def cache_clear(self) -> None:
        """Drop every memoized result and reset the hit/miss counters.

        Example::

            >>> eng = VetEngine("numpy", buckets=64)
            >>> _ = eng.vet_batch(np.linspace(1e-3, 2e-3, 16))
            >>> eng.cache_clear()
            >>> eng.cache_info().size
            0
        """
        self._cache.clear()
        self._cache_hits = 0
        self._cache_misses = 0

    # ------------------------------------------------------------------ API
    def vet_batch(self, times_matrix) -> BatchVetResult:
        """Vet a (workers, window) matrix of raw record times in one call.

        Rows are independent profiles; a 1-D input is treated as one worker.
        For the ``torch``/``cuda`` backends the whole batch is a single
        batched call; ``numpy`` loops the scalar reference per row.
        Results are memoized on the matrix fingerprint.

        Args:
            times_matrix: (workers, window) array-like of per-record times
                in seconds (coerced to float64); 1-D means one worker.

        Returns:
            ``BatchVetResult`` of (workers,) host arrays, frozen
            (read-only — cache hits alias the stored arrays).

        Raises:
            ValueError: when the input has more than two dimensions.

        Example::

            >>> eng = VetEngine("numpy", buckets=64)
            >>> m = np.linspace(1e-3, 2e-3, 32).reshape(2, 16)
            >>> res = eng.vet_batch(m)
            >>> res.workers, res.vet.shape
            (2, (2,))
            >>> bool((res.vet >= 1.0).all())   # PR/EI: 1 == nothing left
            True
        """
        m = np.atleast_2d(np.asarray(times_matrix, dtype=np.float64))
        if m.ndim != 2:
            raise ValueError(f"expected (workers, window) matrix, got {m.shape}")
        return self._memo(self._key("batch", [m]),
                          lambda: self._vet_batch_impl(m))

    def _vet_batch_impl(self, m: np.ndarray) -> BatchVetResult:
        self.dispatches += 1
        self.dispatch_bytes += m.nbytes
        with _span(self.tracer, "engine.dispatch", tid=self.trace_tid,
                   backend=self.backend, kind="batch", rows=int(m.shape[0]),
                   window=int(m.shape[1]), bytes=int(m.nbytes),
                   cold=self._dispatch_cold("batch", m.shape)):
            if self.backend == "numpy":
                return self._numpy_batch(m)
            # Host conversion stays in-span: the device work ends there.
            return self._torch_batch(m)

    # ------------------------------------------------------------ fused path
    def fused_supported(self, max_len: int) -> bool:
        """Whether the fused window-vet kernel serves windows up to
        ``max_len`` on this engine: ``fused`` enabled on a batched backend,
        every window within the kernel's ``MAX_LMAX``, and every row
        non-bucketed (``vet_pipeline`` switches to the bucketed curve at
        ``n >= 4 * buckets``, which the fused kernel does not implement —
        those rows keep the gather path)."""
        return (self.fused and self.backend != "numpy" and max_len <= MAX_LMAX
                and (self.buckets is None or max_len < 4 * self.buckets))

    def _vet_arena_impl(self, arena: np.ndarray, starts: np.ndarray,
                        lengths: np.ndarray) -> BatchVetResult:
        """One fused launch over ragged windows of a shared arena.

        The fused twin of ``_vet_batch_impl``: counts one dispatch, stages
        O(arena + rows) bytes (the kernel reads each window out of the
        arena in place — no gather matrix is ever materialized)."""
        self.dispatches += 1
        max_len = int(lengths.max())
        nbytes = staged_bytes(arena.size, starts.size, max_len)
        self.dispatch_bytes += nbytes
        with _span(self.tracer, "engine.dispatch", tid=self.trace_tid,
                   backend=self.backend, kind="fused",
                   rows=int(starts.size), window=max_len, bytes=int(nbytes),
                   cold=self._dispatch_cold(
                       # Pow2-rounded, as the fused wrapper pads its
                       # launch shapes.
                       "fused", (1 << max(0, arena.size - 1).bit_length(),
                                 1 << max(0, starts.size - 1).bit_length(),
                                 1 << max(0, max_len - 1).bit_length()))):
            vet, ei, oc, pr, t, n = fused_window_vet(
                arena, starts, lengths, omega=self.omega,
                cut_space=self.cut_space, device=self._require_device(),
                plain=self.backend != "cuda")
            return BatchVetResult(vet=vet, ei=ei, oc=oc, pr=pr, t=t, n=n)

    def pad_rows_pow2(self, matrix: np.ndarray):
        """Pad a delta batch to the next power-of-two row count.

        Kept from the reference so the fleet counters (``padded_rows``,
        ``dispatch_bytes``) match it on the same feed: the batched backends
        pad live deltas to the next power of two rows (repeating the last
        row — the caller slices its rows back out), which also keeps the
        set of launch shapes O(log max-delta).  Returns
        ``(matrix, padding_rows)``; the numpy backend never pads.

        Example::

            >>> padded, extra = VetEngine("torch").pad_rows_pow2(
            ...     np.ones((5, 8)))
            >>> padded.shape[0], extra
            (8, 3)
            >>> VetEngine("numpy").pad_rows_pow2(np.ones((5, 8)))[1]
            0
        """
        n = matrix.shape[0]
        if self.backend == "numpy" or n <= 1:
            return matrix, 0
        pad = 1 << (n - 1).bit_length()
        if pad == n:
            return matrix, 0
        return (np.concatenate([matrix,
                                np.repeat(matrix[-1:], pad - n, axis=0)]),
                pad - n)

    def vet_one(self, times) -> VetResult:
        """Scalar convenience wrapper: one profile through the batched path.

        Args:
            times: 1-D array-like of one profile's record times (seconds).

        Returns:
            The scalar ``core.vet.VetResult`` container (0-dim tensors;
            ``float()``/``int()`` them for Python scalars).

        Example::

            >>> r = VetEngine("numpy", buckets=64).vet_one(
            ...     np.linspace(1e-3, 2e-3, 16))
            >>> float(r.vet) >= 1.0 and r.n == 16
            True
        """
        return self.vet_batch(np.atleast_1d(np.asarray(times))[None, :]).task(0)

    def vet_many(self, profiles: Sequence) -> BatchVetResult:
        """Vet ragged profiles (different record counts per worker).

        Equal-length profiles are grouped and vetted in one batched call per
        distinct length; results come back in input order.  This is the entry
        point for controllers whose per-worker buffers fill unevenly.

        Args:
            profiles: sequence of 1-D array-likes, one per worker (record
                counts may differ).

        Returns:
            ``BatchVetResult`` in input order; ``n`` carries each worker's
            record count.

        Raises:
            ValueError: on an empty profile list.

        Example::

            >>> eng = VetEngine("numpy", buckets=64)
            >>> res = eng.vet_many([np.linspace(1e-3, 2e-3, 12),
            ...                     np.linspace(1e-3, 2e-3, 20)])
            >>> res.n.tolist()       # input order, per-worker counts
            [12, 20]
        """
        arrs = [np.atleast_1d(np.asarray(p, dtype=np.float64)).ravel()
                for p in profiles]
        if not arrs:
            raise ValueError("vet_many needs at least one profile")
        return self._memo(self._key("many", arrs),
                          lambda: self._vet_many_impl(arrs))

    def _vet_many_impl(self, arrs) -> BatchVetResult:
        w = len(arrs)
        vet = np.empty(w)
        ei = np.empty(w)
        oc = np.empty(w)
        pr = np.empty(w)
        t = np.empty(w, dtype=np.int32)
        n = np.empty(w, dtype=np.int64)
        groups: dict = {}
        for i, a in enumerate(arrs):
            groups.setdefault(a.size, []).append(i)
        for size, idxs in groups.items():
            # _vet_batch_impl, not vet_batch: one cache entry per *public*
            # call, no re-hash of the materialized per-group matrices.
            br = self._vet_batch_impl(np.stack([arrs[i] for i in idxs]))
            for j, i in enumerate(idxs):
                vet[i], ei[i], oc[i] = br.vet[j], br.ei[j], br.oc[j]
                pr[i], t[i], n[i] = br.pr[j], br.t[j], br.n[j]
        return BatchVetResult(vet=vet, ei=ei, oc=oc, pr=pr, t=t, n=n)

    # ------------------------------------------------------------- windowed
    @staticmethod
    def _as_stream(times) -> np.ndarray:
        arr = np.asarray(times, dtype=np.float64)
        if arr.ndim > 1:
            raise ValueError(
                f"windowed vetting expects a 1-D stream of record times, "
                f"got shape {arr.shape}")
        return np.atleast_1d(arr)

    def vet_sliding(self, times, window: int, stride: int = 1) -> BatchVetResult:
        """Vet every sliding window of a record-time stream in one call.

        Window ``i`` covers ``times[i*stride : i*stride + window]``; the last
        (possibly partial) tail that cannot fill a window is dropped, matching
        the convention of the per-window loops this replaces.  The
        (num_windows, window) matrix is materialized with one vectorized
        gather and vetted by a single ``vet_batch`` dispatch.  Row ``k`` of
        the result is window ``k`` in stream order.

        Args:
            times: 1-D record-time stream.
            window: records per window (>= 2).
            stride: records between window starts (>= 1).

        Returns:
            ``BatchVetResult`` with one row per complete window.

        Raises:
            ValueError: empty stream, ``window < 2``, ``stride < 1``, or
                ``window`` longer than the stream.

        Example::

            >>> eng = VetEngine("numpy", buckets=64)
            >>> times = np.linspace(1e-3, 2e-3, 32)
            >>> eng.vet_sliding(times, window=16, stride=8).workers
            3
            >>> eng.vet_sliding(times[:8], window=16)
            Traceback (most recent call last):
                ...
            ValueError: window (16) exceeds the stream length (8); buffer at least one full window of records before vetting
        """
        t = self._as_stream(times)
        window = int(window)
        stride = int(stride)
        if t.size == 0:
            raise ValueError("vet_sliding needs a non-empty stream of record "
                             "times")
        if window < 2:
            raise ValueError(f"window must cover >= 2 records, got {window}")
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        if window > t.size:
            raise ValueError(
                f"window ({window}) exceeds the stream length ({t.size}); "
                f"buffer at least one full window of records before vetting")
        return self._memo(self._key("sliding", [t], window, stride),
                          lambda: self._vet_sliding_impl(t, window, stride))

    def _vet_sliding_impl(self, t, window, stride) -> BatchVetResult:
        starts = np.arange(0, t.size - window + 1, stride)
        if self.fused_supported(window):
            # One fused launch over the stream itself: memory O(stream),
            # not O(windows x window).
            return self._vet_arena_impl(
                t, starts, np.full(starts.size, window, dtype=np.int64))
        gather = starts[:, None] + np.arange(window)[None, :]
        return self._vet_batch_impl(t[gather])

    def vet_windows(self, times, slices: Sequence) -> BatchVetResult:
        """Vet arbitrary (possibly ragged, possibly overlapping) windows.

        ``slices`` is a sequence of ``(lo, hi)`` half-open index pairs (plain
        ``slice`` objects with step 1 also work) into the 1-D ``times``
        stream.  Windows are gathered vectorized and grouped by length — one
        ``vet_batch`` dispatch per distinct length — and results come back in
        input order.  This is the ragged-window entry point the fig6/fig8
        style "vet every sub-window of a stream" analyses route through.

        Args:
            times: 1-D record-time stream.
            slices: ``(lo, hi)`` half-open pairs (or step-1 ``slice``
                objects) into the stream, each covering >= 2 records.

        Returns:
            ``BatchVetResult`` with one row per slice, in input order.

        Raises:
            ValueError: empty slice list, out-of-bounds or too-short
                windows, or a stepped slice.

        Example::

            >>> eng = VetEngine("numpy", buckets=64)
            >>> times = np.linspace(1e-3, 2e-3, 16)
            >>> res = eng.vet_windows(times, [(0, 12), (4, 16), (0, 16)])
            >>> res.workers, res.n.tolist()
            (3, [12, 12, 16])
        """
        t = self._as_stream(times)
        bounds = self._normalize_slices(slices, t.size)
        return self._memo(self._key("windows", [t, bounds]),
                          lambda: self._vet_windows_impl(t, bounds))

    @staticmethod
    def _normalize_slices(slices, n: int) -> np.ndarray:
        pairs = []
        for s in slices:
            if isinstance(s, slice):
                if s.step not in (None, 1):
                    raise ValueError(f"window slices must have step 1, got {s}")
                lo, hi, _ = s.indices(n)
            else:
                try:
                    lo, hi = (int(s[0]), int(s[1]))
                except (TypeError, IndexError, ValueError):
                    raise ValueError(
                        f"each window must be a (lo, hi) pair or slice, "
                        f"got {s!r}") from None
            if not 0 <= lo < hi <= n:
                raise ValueError(
                    f"window ({lo}, {hi}) out of bounds for a stream of "
                    f"{n} records (need 0 <= lo < hi <= {n})")
            if hi - lo < 2:
                raise ValueError(
                    f"window ({lo}, {hi}) must cover >= 2 records")
            pairs.append((lo, hi))
        if not pairs:
            raise ValueError("vet_windows needs at least one (lo, hi) window; "
                             "got an empty slice list")
        return np.asarray(pairs, dtype=np.int64)

    def _vet_windows_impl(self, t, bounds) -> BatchVetResult:
        lengths = bounds[:, 1] - bounds[:, 0]
        if self.fused_supported(int(lengths.max())):
            # The ragged set is a single block-sparse launch: no grouping
            # by length, no per-group gather — one dispatch total.
            return self._vet_arena_impl(t, bounds[:, 0], lengths)
        # Same group-by-length batching as ragged profiles; the slices are
        # views, so the per-group stack is the materializing gather.
        return self._vet_many_impl([t[lo:hi] for lo, hi in bounds])

    def vet_job(self, profiles: Sequence) -> float:
        """Mean per-task vet over ragged profiles (paper §4.4).

        Example::

            >>> eng = VetEngine("numpy", buckets=64)
            >>> eng.vet_job([np.linspace(1e-3, 2e-3, 12),
            ...              np.linspace(1e-3, 2e-3, 20)]) >= 1.0
            True
        """
        return self.vet_many(profiles).vet_job


@functools.lru_cache(maxsize=None)
def _default_engine_cached(backend: str, omega: int, buckets, cut_space: str,
                           device):
    return VetEngine(backend, omega=omega, buckets=buckets,
                     cut_space=cut_space, device=device)


def default_engine(backend: str = "cuda", *, omega: int = 3,
                   buckets: Optional[int] = 64,
                   cut_space: str = "log", device=None) -> VetEngine:
    """Shared process-wide engine per configuration.

    Control-loop consumers default to ``buckets=64``: their windows are a
    few hundred records, where the full-resolution scan is unnecessary.
    """
    return _default_engine_cached(backend, omega, buckets, cut_space, device)
