"""Tick planning for the vet mux: who gets vetted this tick, and how much.

A ``VetMux`` tick has a fixed amount of estimation work it is willing to do
(the ``budget``, in window rows).  The planner turns the fleet's pending
state into a deterministic service order:

- **Urgency first.**  A stream whose ring headroom is exhausted *must* be
  drained now — deferring it means the next append overruns the ring and a
  later tick raises.  Urgent streams are served in full, even past the
  budget (correctness beats smoothing; the overshoot is visible in the
  plan).
- **Aging, not starvation.**  Within a tenant, streams are ordered by
  ``priority + staleness``: staleness counts consecutive mux ticks a stream
  sat with pending work unserviced, so any fixed priority gap is eventually
  out-aged and every stream is served in bounded time.
- **Tenant fairness.**  The remaining budget is split across tenants with
  pending demand by weighted water-filling (default weight 1): each round
  every active tenant gets its weighted integer share, unused share flows
  back into the pool, and rounds repeat until the budget or the demand is
  exhausted.  A tenant with one hot stream cannot crowd out the rest of the
  fleet.
- **Backpressure.**  Whatever the budget cannot cover is *deferred*, not
  dropped: the plan names the leftover per stream, the mux bumps their
  staleness, and the rows are picked up by later ticks (windows are always
  drained in order, so deferral never skips or reorders results).

Everything is deterministic: ties break on registration order, tenants
iterate in sorted name order, and no randomness is involved — the same fleet
state always yields the same plan (the scenario differential suites depend
on this).

Sharded fleets (``repro.fleet.shard.ShardedVetMux``) reuse the same
machinery one level up: the *job-level* budget is first split across shards
by the identical weighted water-filling (``split_budget`` — each shard's
demand is its streams' total pending rows, unused share flows to shards
that still have demand), and then each shard runs its own ``plan_tick``
over its local streams with its allocated slice — so fairness applies
twice, across shards and within each shard, and both levels stay
deterministic.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Hashable, List, Mapping, NamedTuple, Optional, Sequence, Tuple

__all__ = ["StreamRequest", "TickPlan", "plan_tick", "split_budget"]


class StreamRequest(NamedTuple):
    """One stream's pending state as seen by the planner."""

    stream_id: Hashable
    pending: int  # complete-but-unvetted windows
    priority: float  # larger = served earlier (subject to aging/fairness)
    tenant: str  # fairness-quota group
    staleness: int  # consecutive mux ticks left unserviced with pending > 0
    headroom: int  # appendable records before the ring overruns


class TickPlan(NamedTuple):
    """The planner's verdict for one mux tick."""

    serve: "OrderedDict[Hashable, int]"  # stream -> windows to drain, in order
    deferred: Dict[Hashable, int]  # stream -> pending windows pushed out
    urgent: Tuple[Hashable, ...]  # streams served out-of-budget (overrun risk)

    @property
    def total_rows(self) -> int:
        return sum(self.serve.values())


def plan_tick(
    requests: Sequence[StreamRequest],
    *,
    budget: Optional[int] = None,
    tenant_weights: Optional[Mapping[str, float]] = None,
    urgent_headroom: int = 0,
) -> TickPlan:
    """Order and bound this tick's estimation work; see the module docstring.

    ``budget`` is the window-row cap for the tick (``None`` = unbounded:
    serve everything, still in urgency/priority order).  ``urgent_headroom``
    is the headroom at or below which a stream is treated as
    must-serve-in-full.
    """
    order = {r.stream_id: i for i, r in enumerate(requests)}
    if len(order) != len(requests):
        raise ValueError("duplicate stream_id in plan_tick requests")
    live = [r for r in requests if r.pending > 0]

    def rank(r: StreamRequest):
        # Aging: staleness adds to priority, so deferral is self-correcting.
        return (-(r.priority + r.staleness), order[r.stream_id])

    urgent = sorted((r for r in live if r.headroom <= urgent_headroom),
                    key=rank)
    rest = sorted((r for r in live if r.headroom > urgent_headroom), key=rank)

    serve: "OrderedDict[Hashable, int]" = OrderedDict()
    for r in urgent:
        serve[r.stream_id] = r.pending

    if budget is None:
        for r in rest:
            serve[r.stream_id] = r.pending
        return TickPlan(serve=serve, deferred={},
                        urgent=tuple(r.stream_id for r in urgent))

    weights = dict(tenant_weights or {})
    for t, w in weights.items():
        if w <= 0:
            raise ValueError(f"tenant weight must be > 0, got {t!r}: {w}")

    # Weighted water-filling over the non-urgent demand: per-tenant totals
    # from the shared core, then each tenant's total fills its streams in
    # rank order (same greedy order as the rounds it replaces).
    pool = max(0, int(budget) - sum(r.pending for r in urgent))
    alloc: Dict[Hashable, int] = {r.stream_id: 0 for r in rest}
    queues: Dict[str, List[StreamRequest]] = {}
    for r in rest:  # rest is already rank-sorted; queues inherit the order
        queues.setdefault(r.tenant, []).append(r)
    tenants = sorted(queues)
    totals = _waterfill(pool,
                        [sum(r.pending for r in queues[t]) for t in tenants],
                        [weights.get(t, 1.0) for t in tenants])
    for t, total in zip(tenants, totals):
        for r in queues[t]:
            if total <= 0:
                break
            take = min(r.pending, total)
            alloc[r.stream_id] = take
            total -= take

    for r in rest:  # global rank order, after the urgent block
        if alloc[r.stream_id] > 0:
            serve[r.stream_id] = alloc[r.stream_id]
    deferred = {r.stream_id: r.pending - alloc[r.stream_id]
                for r in rest if r.pending - alloc[r.stream_id] > 0}
    return TickPlan(serve=serve, deferred=deferred,
                    urgent=tuple(r.stream_id for r in urgent))


def _waterfill(pool: int, demands: Sequence[int],
               weights: Sequence[float]) -> List[int]:
    """The shared integer water-filling core (both fairness levels use it:
    ``plan_tick`` across tenants, ``split_budget`` across shards).

    Rounds of demand-capped proportional shares: each round every index
    with unmet demand gets ``pool * w_i / sum(active w)`` (integer floor,
    remainder round-robin in index order), grants are capped at remaining
    demand, unused share flows back into the pool, and rounds repeat until
    the pool or the demand is exhausted.  Deterministic; ties break on
    index order (callers pass keys pre-sorted).
    """
    alloc = [0] * len(demands)
    while pool > 0:
        active = [i for i in range(len(demands)) if demands[i] > alloc[i]]
        if not active:
            break
        total_w = sum(weights[i] for i in active)
        # Floors of the proportional shares, clamped cumulatively to the
        # pool: once pool * w_i / total_w is large enough that a float ulp
        # exceeds 1, the floors alone can sum *above* the pool (the
        # remainder below would go negative — an empty range() — and the
        # round would silently over-allocate past the budget).
        left = pool
        shares = {}
        for i in active:
            s = min(int(pool * weights[i] / total_w), left)
            shares[i] = s
            left -= s
        for j in range(left):  # remainder, round-robin
            shares[active[j % len(active)]] += 1
        granted = 0
        for i in active:
            take = min(demands[i] - alloc[i], shares[i])
            alloc[i] += take
            granted += take
        if granted == 0:
            break
        pool -= granted
    return alloc


def split_budget(
    budget: int,
    demands: Sequence[int],
    *,
    weights: Optional[Sequence[float]] = None,
) -> List[int]:
    """Water-fill an integer row ``budget`` across shards.

    The shard-level half of the two-level fairness scheme (see the module
    docstring): ``demands[k]`` is shard ``k``'s total pending window rows and
    the returned ``alloc[k]`` is its slice of the job budget, never above its
    demand.  Same rules as the per-tenant split inside ``plan_tick``: each
    round every shard with unmet demand gets its weighted proportional share
    (integer floor, remainder round-robin in shard order), unused share flows
    back into the pool, and rounds repeat until the budget or the demand is
    exhausted.  Deterministic: no randomness, ties break on shard index.

    Args:
        budget: job-level window-row cap for one tick (values < 0 clamp
            to 0).
        demands: per-shard pending window rows.
        weights: optional per-shard bias (default: equal).  Must be > 0 and
            match ``len(demands)``.

    Returns:
        Per-shard integer allocations, ``0 <= alloc[k] <= demands[k]`` and
        ``sum(alloc) == min(budget, sum(demands))``.

    Raises:
        ValueError: on a non-positive weight or a weight/demand length
            mismatch.

    Example::

        >>> split_budget(8, [10, 10])
        [4, 4]
        >>> split_budget(8, [2, 10])       # unused share flows to demand
        [2, 6]
        >>> split_budget(9, [12, 12], weights=[2.0, 1.0])
        [6, 3]
        >>> split_budget(100, [3, 0, 1])   # never above demand
        [3, 0, 1]
    """
    k = len(demands)
    if weights is None:
        weights = [1.0] * k
    if len(weights) != k:
        raise ValueError(
            f"weights length {len(weights)} != demands length {k}")
    for i, w in enumerate(weights):
        if w <= 0:
            raise ValueError(f"shard weight must be > 0, got shard {i}: {w}")
    return _waterfill(max(0, int(budget)), demands, weights)
