"""The traced window: ``torch.profiler`` over a fixed number of requests,
reduced to the device's kernels, the benchmark's own spans, the busy and
idle time and the breakdown the result line carries.

The profiler's events are read raw (``kineto_results.events()``), which
keeps the reduction to seconds for some hundred thousand kernels; the
benchmark's spans are ``portbench.*`` ranges on the host, in the same
clock as the device's events.  Busy time is the union of the kernels' and
copies' intervals inside the window.  Each idle gap is put to what the
host was doing when it began: the innermost ``portbench`` span around it
(``prefill``, ``decode``, ``dashboard``; ``request`` between them) or
``between_requests``.
"""

from __future__ import annotations

import bisect
import subprocess
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from .yardstick import busy_intervals, idle_gaps

__all__ = ["power_limit", "reduce", "traced_window"]

_INNER = ("prefill", "decode", "dashboard")
_TOP = 10


def traced_window(fn: Callable[[], object], spans, cuda: bool) -> Dict:
    """Run ``fn`` (the traced requests, their spans recorded into ``spans``
    with ``annotate`` on) under the profiler and reduce its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    return reduce(prof.profiler.kineto_results.events(), spans.spans)


def reduce(events, host_spans) -> Dict:
    """The trace of one traced window from the profiler's raw events and
    the benchmark's host spans (matched to their ranges in order)."""
    from torch.autograd import DeviceType

    kernels, marks = [], defaultdict(list)
    for e in events:
        name = e.name()
        if name.startswith("portbench."):
            if e.device_type() == DeviceType.CPU:
                marks[name[10:]].append((e.start_ns(), e.end_ns()))
            continue
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            kernels.append((name, e.start_ns(), e.end_ns()))
    by_name = defaultdict(list)
    for name, _, _, attrs in sorted(host_spans, key=lambda x: x[1]):
        by_name[name].append(attrs)
    spans = []
    for name, ranges in marks.items():
        for (s, e), attrs in zip(sorted(ranges), by_name[name]):
            spans.append((name, s, e, attrs))
    spans.sort(key=lambda x: x[1])
    req = [(s, e) for n, s, e, _ in spans if n == "request"]
    lo = min(s for s, _ in req) if req else 0
    hi = max(e for _, e in req) if req else 0
    busy = [(max(s, lo), min(e, hi)) for s, e in
            busy_intervals((s, e) for _, s, e in kernels) if e > lo and s < hi]
    busy_ns = sum(e - s for s, e in busy)
    per_op = defaultdict(int)
    for name, s, e in kernels:
        per_op[name] += e - s
    ops = sorted(per_op.items(), key=lambda x: -x[1])[:_TOP]
    idle = defaultdict(int)
    inner = sorted((s, e, n) for n, s, e, _ in spans if n in _INNER)
    starts = [s for s, _, _ in inner]
    outer = sorted(req)
    outer_starts = [s for s, _ in outer]
    for g0, g1 in idle_gaps(busy, lo, hi):
        idle[_host_at(g0, inner, starts, outer, outer_starts)] += g1 - g0
    gaps = sorted(idle.items(), key=lambda x: -x[1])[:_TOP]
    return {"kernels": kernels, "spans": spans, "window_ns": (lo, hi),
            "busy_ns": busy_ns, "busy_s": busy_ns / 1e9,
            "window_s": (hi - lo) / 1e9,
            "breakdown": {"device_ops": [[n[:160], t / 1e9] for n, t in ops],
                          "idle_gaps": [[n, t / 1e9] for n, t in gaps]}}


def _host_at(t: int, inner, starts, outer, outer_starts) -> str:
    j = bisect.bisect_right(starts, t) - 1
    if j >= 0 and inner[j][0] <= t < inner[j][1]:
        return inner[j][2]
    j = bisect.bisect_right(outer_starts, t) - 1
    if j >= 0 and outer[j][0] <= t < outer[j][1]:
        return "request"
    return "between_requests"


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def spans_named(trace: Dict, name: str) -> List[tuple]:
    """The traced window's spans of one name: (start_ns, end_ns, attrs)."""
    return [(s, e, a) for n, s, e, a in trace["spans"] if n == name]


def kernels_within(trace: Dict, ranges) -> List[tuple]:
    """The kernels that start inside any of ``ranges`` ((start, end, ...),
    sorted by start)."""
    ranges = sorted(ranges)
    starts = [r[0] for r in ranges]
    out = []
    for k in trace["kernels"]:
        j = bisect.bisect_right(starts, k[1]) - 1
        if j >= 0 and ranges[j][0] <= k[1] < ranges[j][1]:
            out.append(k)
    return out
