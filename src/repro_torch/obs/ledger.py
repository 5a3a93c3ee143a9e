"""The optimality ledger: the paper's measure applied to the fleet itself.

A copy of ``repro.obs.ledger`` (pure Python).

The source paper judges a Hadoop optimization by the ratio of its measured
cost to an idealized lower bound ("how far from optimal"), not by raw
speedup.  This module applies the same discipline to our own estimation
stack: for every traced tick, compute a roofline-style *floor* for each
pipeline stage from what the engine actually staged (``dispatch_bytes``,
dispatch counts — the same quantities ``benchmarks/roofline.py`` prices
kernels with), and report ``measured / floor`` per stage.  A ratio near 1
means the stage runs as fast as the data movement allows; a large ratio is
unclaimed headroom, and *that ratio* — not wall time — is what later perf
PRs are judged by (ROADMAP items 2 and 3 both consume it).

Floor model (deliberately conservative, mirroring the memory-bound side of
``benchmarks/roofline.py``'s ``roofline_fraction``):

    floor_s(stage) = n_dispatches * DISPATCH_FLOOR_S
                   + staged_bytes / LEDGER_MEM_BW

- ``DISPATCH_FLOOR_S`` (1 us) is a lower bound on any dispatch: below the
  cheapest possible launch/driver round-trip on every backend we run.
- ``LEDGER_MEM_BW`` (200 GB/s) is an optimistic effective host-memory
  bandwidth — higher than any sustained host-side gather we can achieve,
  so ``bytes / LEDGER_MEM_BW`` under-estimates true staging time.

Both constants are chosen so the floor is *sound* (never above a real
measurement) rather than tight; soundness is what the benchmark artifact
and tests pin (``ratio >= 1`` on every backend).  Only spans that carry a
``bytes`` attribute (engine dispatches) get a floor; pure-orchestration
stages (plan, commit, collect) are reported measured-only, since their
floor is genuinely zero.  Cold dispatches — first time the engine sees a
shape, so jit/pallas compilation is in-span — are split into a separate
``<stage> [cold]`` row so compile time cannot masquerade as execution
headroom.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional

from .trace import SpanRecord

__all__ = ["DISPATCH_FLOOR_S", "LEDGER_MEM_BW", "StageLedger",
           "LedgerReport", "ledger_from", "format_ledger"]

DISPATCH_FLOOR_S = 1e-6      # s per dispatch: below any real launch path
LEDGER_MEM_BW = 200e9        # B/s: optimistic effective host bandwidth


class StageLedger(NamedTuple):
    """One span name's aggregate: measured inclusive seconds vs its floor.
    ``floor_s``/``ratio`` are ``None`` for stages with no byte-backed
    floor (orchestration)."""

    stage: str
    calls: int
    measured_s: float
    bytes: int
    floor_s: Optional[float]
    ratio: Optional[float]

    def to_json(self) -> dict:
        return {"stage": self.stage, "calls": self.calls,
                "measured_s": self.measured_s, "bytes": self.bytes,
                "floor_s": self.floor_s, "ratio": self.ratio}


class LedgerReport(NamedTuple):
    """Per-stage ledger rows plus the dispatch-stage aggregate ratio."""

    stages: tuple            # of StageLedger, dispatch stages first
    measured_s: float        # total over floor-bearing (dispatch) stages
    floor_s: float           # total floor over the same stages
    ratio: Optional[float]   # measured_s / floor_s (None if no dispatches)

    def to_json(self) -> dict:
        return {"stages": [s.to_json() for s in self.stages],
                "measured_s": self.measured_s, "floor_s": self.floor_s,
                "ratio": self.ratio}


def ledger_from(records: Iterable[SpanRecord]) -> LedgerReport:
    """Aggregate traced spans into the optimality ledger.

    Spans group by name; spans carrying a ``bytes`` attr additionally
    split on their ``cold`` attr into ``<name> [cold]`` rows (compile
    included in-span) vs warm rows, and only warm+cold dispatch rows get
    floors and feed the headline ratio.
    """
    acc: Dict[str, List] = {}  # stage -> [calls, measured, bytes, floored]
    for r in records:
        r = SpanRecord(*r)
        attrs = dict(r.attrs)
        nbytes = attrs.get("bytes")
        stage = r.name
        if nbytes is not None and attrs.get("cold"):
            stage += " [cold]"
        row = acc.setdefault(stage, [0, 0.0, 0, nbytes is not None])
        row[0] += 1
        row[1] += r.dur
        row[2] += int(nbytes or 0)

    stages: List[StageLedger] = []
    tot_meas = tot_floor = 0.0
    have_floor = False
    for stage, (calls, measured, nbytes, floored) in acc.items():
        if floored:
            floor = calls * DISPATCH_FLOOR_S + nbytes / LEDGER_MEM_BW
            ratio = measured / floor
            tot_meas += measured
            tot_floor += floor
            have_floor = True
        else:
            floor = ratio = None
        stages.append(StageLedger(stage, calls, measured, nbytes,
                                  floor, ratio))
    stages.sort(key=lambda s: (s.floor_s is None, -s.measured_s))
    return LedgerReport(tuple(stages), tot_meas, tot_floor,
                        tot_meas / tot_floor if have_floor else None)


def format_ledger(report: LedgerReport, *, title: str = "optimality ledger") -> str:
    """Fixed-width text table of the ledger (serve dashboard, benchmarks).

    ``x over floor`` is measured/floor for dispatch stages; orchestration
    stages show ``-`` (no meaningful floor).
    """
    head = f"{'stage':<28} {'calls':>6} {'measured':>11} {'floor':>11} {'x over floor':>13}"
    lines = [f"-- {title} --", head, "-" * len(head)]
    for s in report.stages:
        floor = f"{s.floor_s * 1e3:9.3f}ms" if s.floor_s is not None else f"{'-':>11}"
        ratio = f"{s.ratio:12.1f}x" if s.ratio is not None else f"{'-':>13}"
        lines.append(f"{s.stage:<28} {s.calls:>6} {s.measured_s * 1e3:9.3f}ms "
                     f"{floor} {ratio}")
    if report.ratio is not None:
        lines.append("-" * len(head))
        lines.append(f"{'all dispatch stages':<28} {'':>6} "
                     f"{report.measured_s * 1e3:9.3f}ms "
                     f"{report.floor_s * 1e3:9.3f}ms {report.ratio:12.1f}x")
    return "\n".join(lines)
