"""Online regime-shift monitoring on the fleet's vet stream.

The port of ``repro.fleet.anomaly``: methods ``numpy`` (the f64 oracle
scan), ``torch`` (the plain twin ``kernels.changepoint
.changepoint_ragged_plain``) and ``cuda`` (the change-point kernel,
``kernels.changepoint.changepoint_ragged``).  A mux tick hands the monitor
all its streams at once: the due rings go to the card in one buffer, are
cut by one launch and come back in one copy.

The vet measure turns a profile into a scalar "how far from optimal" score;
this module turns the *time series* of those scores into an anomaly monitor
by running the repo's own change-point machinery (``core.changepoint`` /
``kernels.changepoint``) one level up the stack: per stream, the newest
window vets accumulate in a bounded history ring, and every mux tick the
two-segment least-squares scan asks whether the ring splits into two vet
regimes.  A confident split with a material level shift is flagged as a
:class:`RegimeShift` — onset window index, pre/post vet level, confidence —
which ``VetMux``/``ShardedVetMux``/``TransportVetMux`` surface through
``MuxTick.flags`` / ``ShardTick.flags`` and count in ``MuxStats.anomalies``.

Why a change-point and not a threshold: "Performance Tuning of Hadoop
MapReduce: A Noisy Gradient Approach" (arXiv:1611.10052) consumes exactly
this kind of signal as a noisy objective — a regime shift averaged into a
running mean poisons every gradient estimate after the onset, while a
*flagged* shift lets the consumer restart its baseline.  The failure classes
themselves (contention onset, partial-node degradation, failure/restart,
diurnal swings, tier migration) follow "Characterization of Performance
Anomalies in Hadoop" (arXiv:1505.01919) and are modeled one-to-one in
``fleet.scenarios``'s anomaly bank.

Detection ladder: the monitor accepts the same three backends as the engine
(``method="numpy" | "torch" | "cuda"``).  The numpy method is the f64
oracle scan; torch runs the plain twin of the change-point kernel over
the tick's rings, one set of ops per ring length; cuda launches the kernel
once for all of them.  Confidence and the pre/post levels are always
computed host-side in f64 (rings are <= a few dozen points — the backend
choice only moves the argmin search), so the differential suites can
require onset agreement across all three within the scenario bank's
+/-2-tick tolerance.

Heavy-tail hardening — window vets inherit the overhead channel's Pareto
tail, so a naive mean-shift test on raw vets flags every lucky straggler
window.  Three defenses, all cheap:

- the scan runs on **log vets**: a regime shift multiplies the overhead,
  so it is additive in log space, while a single spiky window is
  compressed instead of dominating the SSE;
- the level gate is a **ratio** (``post/pre >= min_ratio`` or the
  inverse), i.e. a shift in *level*, not in variance — statically slow
  hardware (heterogeneous tiers) sits at a constant ratio of 1 and never
  flags;
- a candidate onset must be **stable across ``confirm`` consecutive
  scans** (within one window) before it is raised — a transient spike's
  apparent shift decays as more windows arrive and fails the gates
  before confirmation, while a true onset's cut locks in, at the cost
  of ``confirm - 1`` ticks of flag latency.

    >>> import numpy as np
    >>> mon = AnomalyMonitor(method="numpy", min_points=8)
    >>> pre, post = np.full(6, 1.2), np.full(6, 3.0)
    >>> series = np.concatenate([pre, post])
    >>> mon.observe("w0", series[:10], first=0)  # candidate, 1st sighting
    ()
    >>> mon.observe("w0", series[:11], first=0)  # agrees, 2nd sighting
    ()
    >>> (flag,) = mon.observe("w0", series, first=0)  # confirmed -> raised
    >>> flag.stream_id, flag.onset, flag.pre < flag.post
    ('w0', 6, True)
    >>> mon.raised
    1
"""

from __future__ import annotations

from typing import Dict, Hashable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import runtime
from ..kernels.changepoint.ops import (changepoint_ragged,
                                       changepoint_ragged_plain, pack_rows)

__all__ = ["AnomalyMonitor", "RegimeShift"]

_TINY = 1e-12

_METHODS = ("numpy", "torch", "cuda")


class RegimeShift(NamedTuple):
    """One detected vet-regime shift on one stream.

    ``onset`` is the absolute window index of the first post-shift window
    (for non-overlapping windows — the anomaly bank's geometry — window
    index == mux tick index).  ``confidence`` is the two-segment SSE gap
    ``1 - SSE_two_segment / SSE_single_segment`` in [0, 1]: how much better
    two vet regimes explain the ring than one.
    """

    stream_id: Hashable
    tenant: str
    onset: int
    pre: float  # vet level (geometric mean) before the onset
    post: float  # vet level (geometric mean) from the onset on
    confidence: float


def _closed_form_scan_f64(y: np.ndarray, omega: int) -> np.ndarray:
    """f64 numpy mirror of ``core.changepoint.two_segment_sse``: the SSE of
    the best two-segment linear fit for every candidate prefix length k
    (+inf outside the probing window)."""
    n = y.size
    k = np.arange(1, n + 1, dtype=np.float64)
    cy = np.cumsum(y)
    cyy = np.cumsum(y * y)
    cxy = np.cumsum(k * y)
    sx1 = k * (k + 1.0) / 2.0
    sxx1 = k * (k + 1.0) * (2.0 * k + 1.0) / 6.0
    nf = float(n)
    sx_tot = nf * (nf + 1.0) / 2.0
    sxx_tot = nf * (nf + 1.0) * (2.0 * nf + 1.0) / 6.0

    def seg(m, sx, sy, sxx, sxy, syy):
        m = np.maximum(m, 1.0)
        sxx_c = sxx - sx * sx / m
        sxy_c = sxy - sx * sy / m
        syy_c = syy - sy * sy / m
        safe = sxx_c > 0.0
        sse = syy_c - np.where(safe, sxy_c * sxy_c / np.where(safe, sxx_c, 1.0),
                               0.0)
        return np.maximum(sse, 0.0)

    sse = (seg(k, sx1, cy, sxx1, cxy, cyy)
           + seg(nf - k, sx_tot - sx1, cy[-1] - cy, sxx_tot - sxx1,
                 cxy[-1] - cxy, cyy[-1] - cyy))
    valid = (k >= omega) & (k <= nf - omega)
    return np.where(valid, sse, np.inf)


def _single_segment_sse_f64(y: np.ndarray) -> float:
    """SSE of one linear fit over the whole ring (the null model)."""
    n = y.size
    k = np.arange(1, n + 1, dtype=np.float64)
    sy, syy, sxy = y.sum(), (y * y).sum(), (k * y).sum()
    nf = float(n)
    sx = nf * (nf + 1.0) / 2.0
    sxx = nf * (nf + 1.0) * (2.0 * nf + 1.0) / 6.0
    sxx_c = sxx - sx * sx / nf
    syy_c = syy - sy * sy / nf
    if sxx_c <= 0.0:
        return max(float(syy_c), 0.0)
    sxy_c = sxy - sx * sy / nf
    return max(float(syy_c - sxy_c * sxy_c / sxx_c), 0.0)


class _StreamState:
    """Per-stream ring + watermark + flags already raised."""

    __slots__ = ("ring", "base", "seen", "onsets", "candidate", "hits")

    def __init__(self):
        self.ring: List[float] = []  # newest window vets, oldest first
        self.base = 0  # absolute window index of ring[0]
        self.seen = 0  # vetted-window watermark already consumed
        self.onsets: List[int] = []  # onsets already flagged
        self.candidate: Optional[int] = None  # onset awaiting confirmation
        self.hits = 0  # consecutive scans agreeing on the candidate

    def reset(self, base: int = 0, seen: int = 0) -> None:
        self.ring.clear()
        self.base, self.seen = base, seen
        self.onsets.clear()
        self.candidate = None
        self.hits = 0


class AnomalyMonitor:
    """Bounded-history change-point monitor over per-stream vet series.

    Args:
        method: argmin backend — ``"numpy"`` (f64 oracle scan), ``"torch"``
            (``kernels.changepoint.changepoint_ragged_plain``) or ``"cuda"``
            (``kernels.changepoint.changepoint_ragged``, one launch per
            tick).
        device: torch device of the ``torch``/``cuda`` methods, resolved on
            the first scan (``None``: the ``kernels.runtime`` policy).
        ring: newest window vets retained per stream (bounded memory for
            serve loops that live forever).
        omega: probing-window margin, as in ``core.changepoint``.
        min_points: scans only run once a ring holds this many points
            (never below ``2 * omega`` — shorter rings have no valid split).
        min_confidence: two-segment SSE gap (on log vets) required to flag.
            Deliberately permissive (the null model is a *sloped* line, which
            already absorbs much of a step, and Pareto within-segment noise
            inflates the two-segment SSE) — the ratio and confirmation gates
            carry the false-positive budget.
        min_ratio: multiplicative level shift ``max(post,pre)/min(post,pre)``
            required to flag (keeps statically slow-but-steady streams —
            heterogeneous tiers — from flagging on fit noise).
        confirm: consecutive scans (on fresh data) that must agree on the
            candidate onset, within one window, before it is raised.  A
            transient spike's apparent shift decays as more windows arrive
            and fails the gates before confirmation; a true shift's cut
            locks in.

    Each onset is flagged once: re-detections within ``omega`` ticks of an
    already-raised onset are suppressed, while a genuinely new shift on the
    same stream (e.g. the restart edge after a failure) flags again.
    """

    def __init__(self, method: str = "numpy", *, device=None, ring: int = 64,
                 omega: int = 3, min_points: int = 0,
                 min_confidence: float = 0.25, min_ratio: float = 2.0,
                 confirm: int = 3):
        if method not in _METHODS:
            raise ValueError(f"method must be one of {_METHODS}, "
                             f"got {method!r}")
        if ring < 2 * omega:
            raise ValueError(f"ring must hold >= 2*omega={2 * omega} points, "
                             f"got {ring}")
        self.method = method
        self._device_arg = device
        self.ring = int(ring)
        self.omega = int(omega)
        self.min_points = max(int(min_points), 2 * self.omega)
        self.min_confidence = float(min_confidence)
        self.min_ratio = float(min_ratio)
        self.confirm = max(int(confirm), 1)
        self._streams: Dict[Hashable, _StreamState] = {}
        self._raised = 0

    def __repr__(self) -> str:
        return (f"AnomalyMonitor(method={self.method!r}, ring={self.ring}, "
                f"streams={len(self._streams)}, raised={self._raised})")

    @property
    def raised(self) -> int:
        """Lifetime count of flags raised (``MuxStats.anomalies``)."""
        return self._raised

    # ------------------------------------------------------------ observe
    def observe(self, stream_id: Hashable, vets, *, first: int,
                tenant: str = "default") -> Tuple[RegimeShift, ...]:
        """Consume a stream's retained window vets; return newly raised flags.

        Args:
            stream_id: the stream the series belongs to.
            vets: the retained window vets, oldest first (``BatchVetResult
                .vet`` as the mux collects it; ``None``/empty is a no-op).
            first: absolute window index of ``vets[0]`` (the stream's
                ``first_retained`` watermark) — lets the monitor take only
                windows it has not seen and survive ring eviction.
            tenant: fairness tenant, echoed into the flag.

        Returns:
            Tuple of flags raised by this observation (usually empty).
        """
        return self._observe_tick([(stream_id, vets, first, tenant)])

    def _observe_tick(self, batch) -> Tuple[RegimeShift, ...]:
        """``observe`` for a whole mux tick: ``batch`` holds ``(stream_id,
        vets, first, tenant)`` in registration order.  Rings update one by
        one, then every due ring is scanned together (one change-point call
        for all of them) and the gates run in the same order, so the flags
        equal those of ``observe`` called stream by stream."""
        due = []
        for stream_id, vets, first, tenant in batch:
            st = self._ingest(stream_id, vets, first)
            if st is not None and len(st.ring) >= self.min_points:
                due.append((stream_id, tenant, st))
        return self._scan(due) if due else ()

    def _ingest(self, stream_id: Hashable, vets,
                first: int) -> Optional[_StreamState]:
        """Append a stream's fresh windows to its ring; the stream's state
        if anything was new (a scan is due), else ``None``."""
        if vets is None:
            return None
        v = np.asarray(vets, np.float64).ravel()
        if v.size == 0:
            return None
        st = self._streams.setdefault(stream_id, _StreamState())
        vetted = first + v.size  # stream's vetted-window watermark
        if vetted < st.seen or first > st.seen:
            # Rewind (stream reset / checkpoint restore) or a gap (windows
            # evicted before we saw them): restart the ring at this span.
            st.reset(base=first, seen=first)
        new = v[st.seen - first:]
        if not new.size:
            # No fresh windows: rescanning the same ring would let a noise
            # cut "confirm" itself without new evidence.
            return None
        st.ring.extend(float(x) for x in new)
        st.seen = vetted
        drop = len(st.ring) - self.ring
        if drop > 0:
            del st.ring[:drop]
            st.base += drop
        return st

    def _scan(self, due) -> Tuple[RegimeShift, ...]:
        """Scan the due rings ``[(stream_id, tenant, state)]``: one
        change-point call cuts all of them, then the f64 gates and
        confirmation run stream by stream in order."""
        # Log vets: a regime shift multiplies the overhead channel, so it
        # is additive here, and a single Pareto-tail spike no longer
        # dominates the SSE.  Levels are reported back as geometric means.
        zs = [np.log(np.maximum(np.asarray(st.ring, np.float64), _TINY))
              for _, _, st in due]
        flags = []
        for (stream_id, tenant, st), z, t in zip(due, zs, self._argmins(zs)):
            flags.extend(self._gate(stream_id, tenant, st, z, int(t)))
        return tuple(flags)

    def _gate(self, stream_id: Hashable, tenant: str, st: _StreamState,
              z: np.ndarray, t: int) -> Tuple[RegimeShift, ...]:
        """The f64 gates and confirmation of one ring cut after ``t``
        points (1-indexed prefix length within the ring)."""
        pre = float(np.exp(z[:t].mean()))
        post = float(np.exp(z[t:].mean()))
        sse0 = _single_segment_sse_f64(z)
        sse2 = float(_closed_form_scan_f64(z, self.omega)[t - 1])
        confidence = 0.0 if sse0 <= _TINY else \
            float(np.clip(1.0 - sse2 / sse0, 0.0, 1.0))
        ratio = max(post, pre) / max(min(post, pre), _TINY)
        if confidence < self.min_confidence or ratio < self.min_ratio:
            st.candidate, st.hits = None, 0
            return ()
        onset = st.base + t  # absolute index of the first post-shift window
        if any(abs(onset - prev) <= self.omega for prev in st.onsets):
            return ()
        if st.candidate is None or abs(onset - st.candidate) > 1:
            # First sighting (or the cut moved): restart confirmation.
            st.candidate, st.hits = onset, 1
            return ()
        st.hits += 1
        if st.hits < self.confirm:
            return ()
        st.candidate, st.hits = None, 0
        st.onsets.append(onset)
        self._raised += 1
        return (RegimeShift(stream_id=stream_id, tenant=tenant, onset=onset,
                            pre=pre, post=post, confidence=confidence),)

    def _argmins(self, zs) -> List[int]:
        """The cut of every log ring of ``zs``, in order.  ``numpy`` takes
        the f64 oracle's argmin per ring; ``torch`` and ``cuda`` make one
        change-point call on the monitor's device (the plain twin, the
        kernel): the rings go over in one f32 buffer and the cuts come back
        in one copy."""
        if self.method == "numpy":
            return [int(np.argmin(_closed_form_scan_f64(z, self.omega))) + 1
                    for z in zs]
        dev = runtime.require_device(runtime.resolve_device(self._device_arg))
        (values, starts, lengths), span = pack_rows([z[None] for z in zs],
                                                    dev)
        if self.method == "torch":
            t, _ = changepoint_ragged_plain(values, starts, lengths,
                                            self.omega)
        else:
            t, _ = changepoint_ragged(values, starts, lengths, self.omega,
                                      span=span)
        return t.cpu().tolist()

    # ------------------------------------------------------------- churn
    def forget(self, stream_id: Hashable) -> None:
        """Drop a deregistered stream's state (its raised count survives)."""
        self._streams.pop(stream_id, None)

    # ---------------------------------------------------- checkpointing
    def state_dict(self) -> dict:
        """Pickle-safe snapshot (rings, watermarks, raised-flag dedup)."""
        return {
            "method": self.method,
            "raised": self._raised,
            "streams": [
                {"sid": sid, "ring": list(st.ring), "base": st.base,
                 "seen": st.seen, "onsets": list(st.onsets),
                 "candidate": st.candidate, "hits": st.hits}
                for sid, st in self._streams.items()
            ],
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore a snapshot: detection continues without re-flagging
        shifts the snapshot already raised (the transport crash-recovery
        invariant, same as the mux's committed-window watermark)."""
        self._raised = int(state["raised"])
        self._streams = {}
        for rec in state["streams"]:
            st = _StreamState()
            st.ring = [float(x) for x in rec["ring"]]
            st.base = int(rec["base"])
            st.seen = int(rec["seen"])
            st.onsets = [int(x) for x in rec["onsets"]]
            cand = rec.get("candidate")
            st.candidate = None if cand is None else int(cand)
            st.hits = int(rec.get("hits", 0))
            self._streams[rec["sid"]] = st


def default_monitor(backend: str, device=None) -> AnomalyMonitor:
    """Monitor matched to an engine backend (``VetMux(monitor=True)``)."""
    return AnomalyMonitor(method=backend if backend in _METHODS else "numpy",
                          device=device)
