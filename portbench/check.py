"""The comparison that decides ``correct``: what the timed path produced,
judged by the plain reference (``reference/``) after the window.

For each sampled request the reference runs once over the prompt and the
served tokens (the last one excepted), with the MoE calls grouped as the
program made them (the prompt, then each decode step), and follows the
program's routing, judging each choice (``reference.model``).  Numbers:

- ``route_gap``: the largest relative distance of a routing choice of the
  program (a token's experts, an expert's tokens) from the reference's
  own choice's edge, under the reference's numbers; 0 when every choice
  is the reference's;
- ``logit_err``: the largest ``max |program - reference|`` of a served
  position's logits over the row's ``max |reference|``;
- ``token_gap``: the largest amount by which a served token's reference
  logit lies below the row's best, over the same scale;

and, with the dashboard, over the window rows it vetted:

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
import torch

from .reference import model as R
from .reference.vet import landscape, vet_window

__all__ = ["DASHBOARD_NUMBERS", "MODEL_NUMBERS", "against", "judge",
           "judge_dashboard", "reference_inputs", "vet_err"]

# what every run compares, and what a run with the dashboard adds
MODEL_NUMBERS = ("route_gap", "logit_err", "token_gap")
DASHBOARD_NUMBERS = ("vet_err",)


def reference_inputs(arch: R.Arch, served, device):
    """(tokens (B, N), groups, route, logit positions) of one served
    request for the reference: the prompt and the served tokens but the
    last, the prompt as one MoE call and each decode step as one, the
    program's routing per MoE layer and call."""
    req = served.request
    s, gen = req.prompt_len, req.gen_tokens
    ids = np.concatenate([req.tokens, served.tokens[:, :gen - 1]], axis=1)
    groups = [(0, s)] + [(s + j, s + j + 1) for j in range(gen - 1)]
    n_moe = arch.layers - arch.dense_layers
    calls = served.routing
    if calls is None or len(calls) != n_moe * len(groups):
        raise ValueError(f"{len(calls or ())} MoE calls recorded, expected "
                         f"{n_moe} layers x {len(groups)} calls")
    b = req.tokens.shape[0]
    for g, (lo, hi) in enumerate(groups):
        t = b * (hi - lo)
        want = ((t, arch.top_k), (arch.experts, R.capacity(arch, t)))
        for m in range(n_moe):
            got = tuple(tuple(x.shape) for x in calls[g * n_moe + m])
            if got != want:
                raise ValueError(f"MoE call {g * n_moe + m} routed shapes "
                                 f"{got}, expected {want}")
    route = [[R.Routed(calls[g * n_moe + m][0].to(device),
                       calls[g * n_moe + m][1].to(device))
              for g in range(len(groups))] for m in range(n_moe)]
    positions = [s - 1 + j for j in range(gen)]
    return (torch.from_numpy(ids).to(device), groups, route, positions)


def judge(c: dict, weights, samples, precision: str = "f32") -> Dict[str, float]:
    """``route_gap``, ``logit_err`` and ``token_gap`` over ``samples``
    (``harness.Served`` with logits and routing)."""
    if not samples:
        return {}
    arch = R.Arch.from_file(c)
    device = weights["embed"].device
    out = dict.fromkeys(MODEL_NUMBERS, 0.0)
    for got in samples:
        try:
            ids, groups, route, positions = reference_inputs(arch, got,
                                                             device)
        except ValueError:  # the program's routing is malformed
            return {k: float("inf") for k in out}
        with torch.no_grad():
            hidden, _, judged = R.forward(arch, weights, ids, groups,
                                          route=route, precision=precision)
            ref = R.logits_at(arch, weights, hidden[:, positions],
                              precision)  # (B, gen, V)
        b = ref.shape[0]
        ref = ref.reshape(-1, ref.shape[-1]).cpu()
        prog = got.logits.transpose(0, 1).reshape(ref.shape[0], -1)
        prog = prog[:, :arch.vocab]
        served = torch.from_numpy(got.tokens).reshape(b * len(positions))
        nums = R.judge_logits(prog, ref, served)
        out["route_gap"] = max(out["route_gap"], judged["gap"])
        for k in ("logit_err", "token_gap"):
            out[k] = max(out[k], nums[k])
        del hidden, ref
    return out


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
