"""Streaming vet (beyond-paper): windowed online estimation for live jobs.

The port of ``repro.core.online``: the same EMA over the port's
``VetStream``, so on the ``numpy`` engine its snapshots equal the
reference's bit for bit.

The paper computes vet post-hoc over a task's full profile.  A production
dashboard needs it *during* the run: this maintains a bounded reservoir of
recent records and re-estimates (EI, OC, vet) incrementally, with exponential
forgetting across windows so regime changes (a straggler appearing, input
storage degrading) surface within one window.

Estimation is delegated to a ``repro_torch.engine.stream.VetStream`` — this
class is only the EMA wrapper around it.  ``feed`` appends whole chunks
(O(chunk), no per-record Python loop) and window completions fall out of the
stream's arithmetic; each completed half-window-spaced window is vetted by the
stream's *incremental* tick (only the new windows are dispatched, earlier
rows are reused, and replayed ticks hit the engine's result cache via the
stream's rolling fingerprint).  Properties kept from the batch estimator:
scale-equivariance, EI+OC == PR per window, vet >= 1 on well-formed profiles.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

__all__ = ["OnlineVet", "OnlineVetSnapshot"]


class OnlineVetSnapshot(NamedTuple):
    vet: float
    ei_rate: float  # EI per record (seconds) — the live ideal-cost estimate
    pr_rate: float  # PR per record
    n_window: int
    smoothed_vet: float


class OnlineVet:
    """Online vet with an O(window) ring of live records.

    feed(times) appends record times; every ``window // 2`` records (once the
    first full window has filled) a fresh estimate runs on the newest window
    and folds into an EMA.  Live records occupy an O(window) ring; the
    backing stream additionally retains six scalars per completed window of
    result history (its prefix-oracle contract), which grows with stream
    length unless ``history=`` caps it — an estimator meant to live for the
    whole deployment should pass a cap (the EMA itself only ever needs the
    newest rows; evicted rows shift the stream's ``first_retained`` and the
    fold accounts for the offset).

    ``engine`` is the backing ``VetEngine``; when omitted, a shared default
    (cuda backend, ``buckets`` as given) is used.  With an explicit engine
    its own bucketing configuration wins over ``buckets``.  Construction
    touches no CUDA state: the engine resolves its device at its first
    dispatch, and raises there when that is ``cuda`` and no card is
    present.

    Args:
        window: records per estimate (>= 64; refresh every ``window // 2``).
        alpha: EMA weight for the newest window's vet.
        buckets: change-point bucketing for the default engine.
        engine: explicit backing ``VetEngine``.
        history: cap on retained per-window result rows (clamped up to the
            stream's geometric safe minimum; pass one for long-lived
            estimators).

    Raises:
        ValueError: ``window < 64``.

    Example::

        >>> import numpy as np
        >>> from repro_torch.engine import VetEngine
        >>> ov = OnlineVet(window=64, engine=VetEngine("numpy", buckets=16))
        >>> snaps = ov.feed(np.linspace(1e-3, 2e-3, 200))
        >>> len(snaps)                 # windows complete at 64, 96, ... 192
        5
        >>> ov.snapshot is snaps[-1] and snaps[-1].n_window == 64
        True
    """

    def __init__(self, window: int = 512, alpha: float = 0.3,
                 buckets: Optional[int] = 64, engine=None,
                 history: Optional[int] = None):
        if window < 64:
            raise ValueError("window must be >= 64")
        self.window = window
        self.alpha = alpha
        self.buckets = buckets
        if engine is None:
            from ..engine import default_engine  # deferred: engine -> core.vet

            engine = default_engine("cuda", buckets=buckets)
        self.engine = engine
        from ..engine import VetStream  # deferred: engine -> core.vet

        # Half-window stride = the refresh cadence; 4x capacity keeps the
        # sliding() drill-down view resident and bounds per-feed sub-chunks.
        stride = max(1, window // 2)
        capacity = 4 * window
        # The stream may not evict a row before feed() has folded it: one
        # tick commits at most (capacity - window) // stride + 1 rows (every
        # unvetted window is still ring-resident), and feed() folds after
        # every tick, so clamping the stream cap to that geometric bound
        # keeps any user history= exact (it is a small constant — memory
        # stays O(window)).
        if history is not None:
            history = max(int(history), (capacity - window) // stride + 1)
        self._stream = VetStream(engine, window=window, stride=stride,
                                 capacity=capacity, history=history)
        self._emitted = 0  # windows already folded into the EMA
        self._smoothed: Optional[float] = None
        self._last: Optional[OnlineVetSnapshot] = None

    def feed(self, times) -> List[OnlineVetSnapshot]:
        """Add a chunk of record times; returns every snapshot it emits.

        A single call can span several window completions (e.g. a large chunk
        of buffered records arriving at once) — each completed window yields
        its own snapshot, in stream order.  An empty list means no window
        completed.  Chunks are appended vectorized; completions are computed
        arithmetically by the backing stream, so chunked and record-at-a-time
        feeds emit identical snapshot lists.

        Args:
            times: 1-D chunk of record times (seconds), any size.

        Returns:
            The ``OnlineVetSnapshot`` list this chunk completed (possibly
            empty), oldest first.

        Example::

            >>> import numpy as np
            >>> from repro_torch.engine import VetEngine
            >>> ov = OnlineVet(window=64,
            ...                engine=VetEngine("numpy", buckets=16))
            >>> ov.feed(np.linspace(1e-3, 2e-3, 63))    # one short of a window
            []
            >>> [round(s.smoothed_vet, 6) == round(s.vet, 6)
            ...  for s in ov.feed([2e-3])]              # first fold: EMA seed
            [True]
        """
        out: List[OnlineVetSnapshot] = []
        # The stream sub-chunks by its ring budget; the pressure hook folds
        # after *every* forced tick: with a bounded history a tick's commit
        # evicts rows past the cap, so folding must never lag a tick or
        # capped streams would skip snapshots on large chunks (the history
        # clamp in __init__ holds exactly because of this pairing).
        self._stream.feed(
            times,
            on_pressure=lambda: self._fold_new(self._stream.tick(), out))
        self._fold_new(self._stream.tick(), out)
        return out

    def _fold_new(self, res, out: List[OnlineVetSnapshot]) -> None:
        """Fold every not-yet-emitted row of a tick result into the EMA."""
        if res is None:
            return
        # Windows re-vetted via stream.amend()/invalidate() since the
        # last feed re-fold from the first corrected row (the EMA is
        # order-sensitive, so a correction perturbs rather than rewrites
        # the smoothed history — but snapshots reflect corrected data).
        rewound = self._stream.consume_rewind()
        if rewound is not None:
            self._emitted = min(self._emitted, rewound)
        # With a bounded history, row j of the result is window base + j.
        base = self._stream.first_retained
        self._emitted = max(self._emitted, base)
        for k in range(self._emitted, base + res.workers):
            out.append(self._fold(float(res.vet[k - base]),
                                  float(res.ei[k - base]),
                                  float(res.pr[k - base])))
        self._emitted = base + res.workers

    def _fold(self, vet: float, ei: float, pr: float) -> OnlineVetSnapshot:
        self._smoothed = (vet if self._smoothed is None
                          else self.alpha * vet + (1 - self.alpha) * self._smoothed)
        self._last = OnlineVetSnapshot(
            vet=vet,
            ei_rate=ei / self.window,
            pr_rate=pr / self.window,
            n_window=self.window,
            smoothed_vet=self._smoothed,
        )
        return self._last

    def sliding(self, window: int, stride: int = 1):
        """Batched vet over every sliding sub-window of the current buffer.

        The dashboard drill-down view: one ``VetEngine.vet_sliding`` call
        (cached across ticks while the buffer is unchanged) over the newest
        ``self.window`` records.  Raises if fewer than ``window`` records
        are buffered.

        Args:
            window: sub-window length (>= 2, <= buffered records).
            stride: records between sub-window starts.

        Returns:
            ``BatchVetResult`` over the sub-windows, oldest first.

        Raises:
            ValueError: when fewer than ``window`` records are buffered
                (or the geometry is invalid).

        Example::

            >>> import numpy as np
            >>> from repro_torch.engine import VetEngine
            >>> ov = OnlineVet(window=64,
            ...                engine=VetEngine("numpy", buckets=16))
            >>> _ = ov.feed(np.linspace(1e-3, 2e-3, 96))
            >>> ov.sliding(window=32, stride=16).workers
            3
        """
        return self.engine.vet_sliding(self._stream.latest(self.window),
                                       window=window, stride=stride)

    @property
    def stream(self):
        """The backing ``VetStream`` (stats, resident buffer, amend hooks)."""
        return self._stream

    @property
    def snapshot(self) -> Optional[OnlineVetSnapshot]:
        return self._last
