"""The comparison that decides ``correct``: what the timed path produced,
judged by the plain reference (``reference/``) after the window.

The model's numbers are its family's (``families``): each family's
``judge`` runs its reference over the sampled requests and gives its
``NUMBERS``, which always hold ``logit_err`` (the largest ``max |program -
reference|`` of a served position's logits over the row's ``max
|reference|``) and ``token_gap`` (the largest amount by which a served
token's reference logit lies below the row's best, over the same scale);
the DeepSeek MoE family adds ``route_gap``, the program's routing judged
choice by choice.  A run with the dashboard adds, over the window rows it
vetted:

- ``vet_err``: the larger of the reference's (f64) summed squared error at
  the program's change-point above its least, over its least (how far the
  program's cut lies from a tie with the reference's), and the program's
  vet against the reference's at the program's cut, relative.  One number:
  the control (the vet in bfloat16) moves either the cut or the value, and
  a cut alone never separates it from the program.  It reads inf when the
  units fed made no window due, or when the dashboard vetted fewer or more
  windows than were due: a run whose dashboard vets nothing has not shown
  that it vets right.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import families
from .reference.vet import landscape, vet_window

__all__ = ["DASHBOARD_NUMBERS", "against", "judge", "judge_dashboard",
           "vet_err"]

# what a run with the dashboard adds to its family's numbers
DASHBOARD_NUMBERS = ("vet_err",)


def judge(c: dict, weights, samples, precision: str = "f32") -> Dict[str, float]:
    """Its family's ``NUMBERS`` over ``samples`` (``harness.Served`` with
    logits and routing), from its family's reference."""
    return families.of(c).judge(c, weights, samples, precision)


def judge_dashboard(windows, units: List[float], dash: dict,
                    ) -> Dict[str, float]:
    """``vet_err`` over the window rows the dashboard vetted (``(first
    retained window, rows)`` or None), from the units it was fed."""
    w, stride = dash["window"], dash["stride"]
    due = 0 if len(units) < w else (len(units) - w) // stride + 1
    first, rows = windows if windows is not None else (0, None)
    vetted = 0 if rows is None else first + len(rows.vet)
    if due == 0 or vetted != due:
        return {"vet_err": float("inf")}
    err = 0.0
    for j in range(len(rows.vet)):
        k = first + j
        times = np.asarray(units[k * stride:k * stride + w], dtype=np.float64)
        if times.size < w:
            raise ValueError(f"window {k} vetted with {times.size} of "
                             f"{w} units fed")
        err = max(err, vet_err(times, int(rows.t[j]), float(rows.vet[j]),
                               dash["buckets"]))
    return {"vet_err": err}


def vet_err(times, t: int, vet: float, buckets) -> float:
    """One window's ``vet_err``: a cut ``t`` and a ``vet`` judged by the
    reference on ``times``."""
    sse = landscape(times, buckets=buckets)
    best = float(sse.min())
    at = float(sse[t - 1]) if 1 <= t <= sse.numel() else float("inf")
    ref = vet_window(times, buckets=buckets, t=t)["vet"]
    return max((at - best) / max(best, 1e-300), abs(vet - ref) / abs(ref))


def against(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Dict[str, Dict[str, Optional[float]]]:
    """Each number beside its limit; a number that is not finite reads
    inf, and a limit's number that the run did not produce is left out."""
    out = {}
    for name, limit in limits.items():
        if name not in numbers:
            continue
        v = float(numbers[name])
        out[name] = {"value": v if np.isfinite(v) else float("inf"),
                     "limit": float(limit)}
    return out
