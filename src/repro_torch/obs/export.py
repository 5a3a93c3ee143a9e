"""Trace export: Chrome trace-event JSON (Perfetto-loadable) + flamegraph.

A copy of ``repro.obs.export`` (pure Python).

``to_chrome`` turns a list of ``SpanRecord``s — including cross-process
records adopted from transport workers — into the Chrome trace-event
format (the ``{"traceEvents": [...]}`` object form), loadable in
``chrome://tracing`` and https://ui.perfetto.dev.  Each span becomes one
complete event (``ph: "X"``) with microsecond ``ts``/``dur``; process
lanes get ``process_name`` metadata events so the viewer labels driver
vs shard workers.

``validate_chrome`` is the schema gate CI and the benchmark artifact test
run against every exported trace: required keys and types on every event,
and well-formed nesting — within each ``(pid, tid)`` lane, spans must
strictly nest (no partial overlap), verified by a time-sorted stack sweep.

``flamegraph`` renders the same records as an indented text tree (inclusive
durations, call counts), aggregated by span-name path — the terminal-
friendly summary the serve dashboard and ``benchmarks/fleet_obs.py`` print.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .trace import SpanRecord, Tracer

__all__ = ["to_chrome", "write_chrome", "validate_chrome", "flamegraph"]

_US = 1e6
# Float round-off tolerance for the nesting sweep, in us.  Chrome ts/dur
# come from float-seconds clocks scaled by 1e6; sibling boundaries can
# land within a rounding error of each other.
_EPS_US = 0.5


def to_chrome(records: Sequence[SpanRecord], *,
              process_names: Optional[Dict[int, str]] = None) -> dict:
    """Chrome trace-event object for ``records``.

    Timestamps are normalized so the earliest span starts at ``ts=0`` and
    scaled to integer-friendly microseconds (floats are legal in the
    format; we keep them for sub-us spans).  Span attrs land in ``args``,
    along with the tracer-side span/parent ids (``sid``/``parent``) so a
    trace can be joined back to ledger rows.
    """
    records = [SpanRecord(*r) for r in records]
    events: List[dict] = []
    names = dict(process_names or {})
    for pid in sorted({r.pid for r in records} | set(names)):
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": names.get(pid, f"proc{pid}")},
        })
    t0 = min((r.ts for r in records), default=0.0)
    for r in records:
        args = dict(r.attrs)
        args["sid"] = r.sid
        if r.parent is not None:
            args["parent"] = r.parent
        events.append({
            "name": r.name, "ph": "X",
            "ts": (r.ts - t0) * _US, "dur": r.dur * _US,
            "pid": r.pid, "tid": r.tid, "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome(path, source, *, indent: int = 1) -> dict:
    """Serialize ``source`` (a ``Tracer`` or a record list) to ``path``.
    Returns the written object (handy for immediate validation)."""
    if isinstance(source, Tracer):
        obj = to_chrome(source.records, process_names=source.process_names)
    else:
        obj = to_chrome(source)
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent, sort_keys=True, default=float)
        f.write("\n")
    return obj


def validate_chrome(obj: dict) -> List[str]:
    """Schema-check a Chrome trace object; returns a list of problems
    (empty == valid).  Checks, per the trace-event format:

    - top level is ``{"traceEvents": [...]}``
    - every ``X`` event has ``name``/``ts``/``dur``/``pid``/``tid`` with
      the right types, ``ts >= 0`` and ``dur >= 0``
    - within each ``(pid, tid)`` lane, ``X`` events strictly nest — a
      stack sweep over ``(ts, -dur)``-sorted events finds no partial
      overlap (boundaries tolerate ``0.5us`` of float round-off)
    """
    problems: List[str] = []
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        return ["top level must be a dict with a 'traceEvents' list"]

    lanes: Dict[Tuple[int, int], List[Tuple[float, float, str]]] = {}
    for i, ev in enumerate(obj["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph == "M":
            continue
        if ph != "X":
            problems.append(f"{where}: unsupported ph {ph!r}")
            continue
        bad = False
        for key, types in (("name", str), ("ts", (int, float)),
                           ("dur", (int, float)), ("pid", int),
                           ("tid", int)):
            if not isinstance(ev.get(key), types):
                problems.append(f"{where}: missing or mistyped {key!r} "
                                f"(got {ev.get(key)!r})")
                bad = True
        if bad:
            continue
        if ev["ts"] < 0 or ev["dur"] < 0:
            problems.append(f"{where}: negative ts/dur")
            continue
        lanes.setdefault((ev["pid"], ev["tid"]), []).append(
            (float(ev["ts"]), float(ev["dur"]), ev["name"]))

    for (pid, tid), spans in sorted(lanes.items()):
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: List[Tuple[float, float, str]] = []  # (ts, end, name)
        for ts, dur, name in spans:
            while stack and ts >= stack[-1][1] - _EPS_US:
                stack.pop()
            if stack and ts + dur > stack[-1][1] + _EPS_US:
                problems.append(
                    f"lane (pid={pid}, tid={tid}): span {name!r} "
                    f"[{ts:.3f}, {ts + dur:.3f}]us partially overlaps "
                    f"enclosing {stack[-1][2]!r} ending {stack[-1][1]:.3f}us")
                continue
            stack.append((ts, ts + dur, name))
    return problems


def flamegraph(records: Iterable[SpanRecord], *, width: int = 40) -> str:
    """Indented text flamegraph: one line per distinct span-name *path*
    (root span name down to this span's name), with inclusive total
    seconds, call count, and a proportional bar.

    Paths aggregate across processes and lanes — ``fleet.tick >
    mux.tick > engine.dispatch`` is one line whether it ran on the driver
    or on three shard workers — because the question this view answers is
    "which stage of the pipeline costs what", not "which copy of it".
    """
    records = [SpanRecord(*r) for r in records]
    by_sid = {r.sid: r for r in records}

    def path_of(r: SpanRecord) -> Tuple[str, ...]:
        parts = [r.name]
        seen = {r.sid}
        while r.parent is not None and r.parent in by_sid:
            r = by_sid[r.parent]
            if r.sid in seen:  # defensive: corrupt parent links
                break
            seen.add(r.sid)
            parts.append(r.name)
        return tuple(reversed(parts))

    totals: Dict[Tuple[str, ...], List[float]] = {}
    for r in records:
        agg = totals.setdefault(path_of(r), [0.0, 0])
        agg[0] += r.dur
        agg[1] += 1
    if not totals:
        return "(no spans)"

    roots = sum(dur for path, (dur, _) in totals.items() if len(path) == 1)
    scale = roots or max(dur for dur, _ in totals.values()) or 1.0
    children: Dict[Tuple[str, ...], List[Tuple[str, ...]]] = {}
    for path in totals:
        children.setdefault(path[:-1], []).append(path)

    lines: List[str] = []

    def emit(path: Tuple[str, ...]) -> None:
        dur, count = totals[path]
        bar = "#" * max(1, int(round(width * dur / scale)))
        pad = max(1, 34 - 2 * (len(path) - 1))
        lines.append(f"{'  ' * (len(path) - 1)}{path[-1]:<{pad}} "
                     f"{dur * 1e3:9.3f} ms  x{count:<5d} {bar}")
        for child in sorted(children.get(path, ()),
                            key=lambda p: -totals[p][0]):
            emit(child)

    for root in sorted(children.get((), ()), key=lambda p: -totals[p][0]):
        emit(root)
    return "\n".join(lines)
