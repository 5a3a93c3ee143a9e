"""Resource-aware scheduling driven by the vet measure (paper §5.5).

The port of ``repro.sched.straggler``: the same decision logic over the
port's ``VetMux``/``ShardedVetMux``, so on ``numpy`` engines its decisions,
reasons and worker vets equal the reference's bit for bit.  On the default
``cuda`` engine (``buckets=64``) a ``decide()`` vets the fleet's new
windows of fewer than ``4 * buckets`` records in one fused window-vet
launch per mux, adds one change-point launch per mux whose anomaly monitor
has due rings, and one per distinct buffer length of its warm-up workers.

The paper's rule: "given the number of tasks calculated as W, if the
vet_task of the tasks is higher than W, the scheduler should reduce the
number of tasks."  Generalized here into a controller that consumes live
per-worker record profiles and emits concurrency / straggler decisions:

  * vet_job >> 1 with EI stable   -> host is oversubscribed: lower worker
    count (or microbatch concurrency) until vet approaches the knee.
  * one worker's vet an outlier   -> straggler: flag for re-shard/eviction
    (KS test against the pooled population confirms it is not noise).

Estimation routes through one ``repro_torch.fleet.VetMux`` holding a
per-worker ``VetStream``: ``feed`` appends chunks into a worker's ring buffer
in O(chunk), and ``decide()`` is a single mux tick — every worker's newly
complete windows are drained and coalesced into one batched engine dispatch
per window-length bucket (all workers share one geometry here, so one
dispatch covers the whole fleet) instead of the former one-stream-at-a-time
loop of O(workers) dispatches.  Workers that received no records between
decisions reuse their previous rows outright (no re-gather, no buffer
re-hash), so an idle poll pays nothing per quiet worker.  Workers still
warming up (fewer than a full window of records) are vetted over their
resident buffers in one batched, memoized ``vet_many`` call.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import ks_2samp
from ..engine import VetEngine, default_engine
from ..fleet import ShardedVetMux, VetMux

__all__ = ["SchedulerDecision", "VetController"]


@dataclass
class SchedulerDecision:
    target_workers: int
    stragglers: List[int] = field(default_factory=list)
    vet_job: float = 1.0
    reason: str = ""
    worker_vets: Dict[int, float] = field(default_factory=dict)


class VetController:
    """Windowed vet-based concurrency controller.

    feed() per-worker record times; decide() returns the recommended worker
    count and straggler set.  Hysteresis: only moves one step per decision,
    and only when the vet signal clears the deadband.

    Args:
        n_workers: initial worker count (one stream per worker).
        min_workers / max_workers: clamp for the W-rule recommendation.
        window_records: records per vetting window.
        vet_high / vet_low: shrink/grow hysteresis deadband on ``vet_job``.
        straggler_pvalue / straggler_ratio: KS confirmation threshold and
            the vet-outlier multiple that nominates a straggler candidate.
        engine: backing ``VetEngine`` (shared default when omitted).
        shards: opt-in fleet sharding — with ``shards > 1`` estimation
            routes through a ``ShardedVetMux`` (``engine`` is the template
            for the per-shard engines, each shard modeling one process) and
            ``decide()`` reads the shard-merged job reduction; with the
            default ``1`` a plain single ``VetMux`` is used.

    Example::

        >>> import numpy as np
        >>> ctl = VetController(4, engine=VetEngine("numpy", buckets=64),
        ...                     shards=2)
        >>> for w in range(4):
        ...     ctl.feed(w, np.linspace(1e-3, 2e-3, 64))
        >>> d = ctl.decide()
        >>> d.target_workers <= 4 and len(d.worker_vets) == 4
        True
    """

    def __init__(
        self,
        n_workers: int,
        *,
        min_workers: int = 1,
        max_workers: Optional[int] = None,
        window_records: int = 200,
        vet_high: float = 1.5,  # above the paper's W-rule knee => shrink
        vet_low: float = 1.1,  # near-ideal => can grow
        straggler_pvalue: float = 0.01,
        straggler_ratio: float = 1.5,
        engine: Optional[VetEngine] = None,
        shards: int = 1,
    ):
        self.n_workers = n_workers
        self.min_workers = min_workers
        self.max_workers = max_workers or n_workers
        self.window = window_records
        self.vet_high = vet_high
        self.vet_low = vet_low
        self.straggler_pvalue = straggler_pvalue
        self.straggler_ratio = straggler_ratio
        self.engine = engine if engine is not None else default_engine("cuda")
        # One mux across the whole worker fleet: decide() drains every
        # worker's newly complete windows in one coalesced dispatch set.
        # With shards > 1 the fleet is partitioned across shard muxes (one
        # engine each — the cross-process scaling path) and decide() merges
        # the per-shard reductions; the decision logic is identical.
        if int(shards) > 1:
            self.mux = ShardedVetMux(int(shards), engine=self.engine)
        else:
            self.mux = VetMux(self.engine)
        for i in range(n_workers):
            self._register(i)

    def _register(self, worker_id: int) -> None:
        # Half-window stride: a worker's vet refreshes every window/2 records;
        # 4x capacity bounds the per-feed sub-chunks and keeps the latest full
        # window resident for the KS straggler test.  decide() only reads the
        # newest row per worker, so a small bounded history keeps a long-lived
        # fleet's memory O(workers), not O(records ever seen).
        self.mux.register(worker_id, window=self.window,
                          stride=max(1, self.window // 2),
                          capacity=4 * self.window, history=8)

    def feed(self, worker_id: int, record_times: Sequence[float]) -> None:
        """Append one worker's newly observed record times (seconds).

        O(chunk) ingest: the mux only ticks mid-feed if overrun protection
        forces it (coalesced even then); estimation otherwise waits for
        ``decide()``.  Unknown workers are auto-registered (elastic fleets).

        Example::

            >>> ctl = VetController(1, engine=VetEngine("numpy", buckets=64))
            >>> ctl.feed(0, np.linspace(1e-3, 2e-3, 16))
            >>> ctl.feed(7, [1e-3])          # a brand-new worker joins
            >>> len(ctl.mux)
            2
        """
        if worker_id not in self.mux:
            self._register(worker_id)
        self.mux.feed(worker_id,
                      np.asarray(record_times, dtype=np.float64).ravel())

    def ready(self) -> bool:
        """True once every worker has the 32 records ``decide`` needs.

        Example::

            >>> ctl = VetController(1, engine=VetEngine("numpy", buckets=64))
            >>> ctl.ready()
            False
            >>> ctl.feed(0, np.linspace(1e-3, 2e-3, 32))
            >>> ctl.ready()
            True
        """
        return all(self.mux.stream(i).total_records >= 32
                   for i in self.mux.ids())

    def decide(self) -> SchedulerDecision:
        """One coalesced estimation pass -> a concurrency recommendation.

        Ticks the fleet mux (only workers with newly complete windows cost
        anything; warmup workers fall back to one memoized ``vet_many``),
        flags KS-confirmed vet outliers as stragglers, and applies the
        paper's W-rule with hysteresis to ``vet_job``.

        Returns:
            ``SchedulerDecision`` with ``target_workers``, ``stragglers``,
            ``vet_job``, per-worker vets and a human-readable ``reason``
            (``"insufficient data"`` until some worker has 32 records).
        """
        ids = [i for i in self.mux.ids()
               if self.mux.stream(i).total_records >= 32]
        if not ids:
            return SchedulerDecision(self.n_workers, reason="insufficient data")
        # Buffer copies are gathered lazily: an idle poll (no new windows, no
        # outlier candidates) never materializes a single profile.
        profiles: Dict[int, np.ndarray] = {}

        def profile(i: int) -> np.ndarray:
            if i not in profiles:
                profiles[i] = self.mux.stream(i).latest(self.window)
            return profiles[i]

        # One mux tick for the whole fleet: only workers that completed new
        # windows since the last decision contribute rows, and all of them
        # share one batched dispatch per window-length bucket.  Workers still
        # short of their first full window are vetted over their resident
        # buffers in one batched vet_many (grouped by length, memoized — an
        # unchanged warmup fleet is a single cache hit).
        tick = self.mux.tick()
        vets: Dict[int, float] = {}
        warmup: List[int] = []
        for i in ids:
            res = tick.results[i]
            if res is not None:
                vets[i] = float(res.vet[-1])
            else:
                warmup.append(i)
        if warmup:
            # Group by backing engine: with shards= each shard's warmup
            # profiles are vetted on that shard's own engine (one memoized
            # vet_many per shard), preserving the per-process model —
            # fleet-wide warmup never funnels through a single engine.
            by_engine: Dict[int, tuple] = {}
            for i in warmup:
                eng = self.mux.stream(i).engine
                by_engine.setdefault(id(eng), (eng, []))[1].append(i)
            for eng, ids_ in by_engine.values():
                batch = eng.vet_many([profile(i) for i in ids_])
                vets.update((i, float(v)) for i, v in zip(ids_, batch.vet))
        vj = float(np.mean(list(vets.values())))

        # --- straggler detection: per-worker vet outliers confirmed by KS ---
        med = float(np.median(list(vets.values())))
        stragglers = []
        candidates = [i for i, v in vets.items()
                      if v > self.straggler_ratio * med] if len(ids) > 2 else []
        if candidates:
            pooled = np.concatenate([profile(i) for i in ids])
            for i in candidates:
                ks = ks_2samp(profile(i), pooled)
                if ks.pvalue < self.straggler_pvalue:
                    stragglers.append(i)

        # --- paper's W-rule with hysteresis ---
        target = self.n_workers
        reason = "steady"
        if vj > max(self.vet_high, float(self.n_workers)):
            # vet above the worker count: hopelessly oversubscribed
            target = max(self.min_workers, self.n_workers - 1)
            reason = f"vet_job {vj:.2f} > workers {self.n_workers} (paper W-rule)"
        elif vj > self.vet_high:
            target = max(self.min_workers, self.n_workers - 1)
            reason = f"vet_job {vj:.2f} > {self.vet_high}: shrink"
        elif vj < self.vet_low and self.n_workers < self.max_workers:
            target = self.n_workers + 1
            reason = f"vet_job {vj:.2f} < {self.vet_low}: headroom, grow"

        return SchedulerDecision(
            target_workers=target, stragglers=stragglers, vet_job=vj,
            reason=reason, worker_vets=vets,
        )

    def apply(self, decision: SchedulerDecision) -> None:
        """Adopt a decision's worker count (the caller resizes the pool)."""
        self.n_workers = decision.target_workers
