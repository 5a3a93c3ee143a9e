"""Ground-truth record-time simulator (paper Fig. 4/5 cost model).

Generates synthetic record processing times with the paper's decomposition —

    time(record) = base cost (CPU + memory, near-constant with slight ramp)
                 + unavoidable I/O cost (sparse, fixed-ish: disk access every
                   ~few ms of work; the paper's "normal (CPU+I/O)" records)
                 + reducible overhead (sparse, heavy-tailed Pareto: context
                   switching, blocked I/O — what an optimizer could remove)

— and returns the *true* ideal total alongside, so tests can verify that EI
recovers the ideal and OC recovers the injected overhead.  This is the
controlled-validation path; the contention harness provides the real-measurement
path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["SimProfile", "simulate_records", "simulate_job"]


class SimProfile(NamedTuple):
    times: np.ndarray  # observed per-record seconds
    ideal: np.ndarray  # per-record seconds without reducible overhead
    overhead: np.ndarray  # injected reducible overhead per record
    true_ei: float  # sum(ideal)
    true_oc: float  # sum(overhead)

    @property
    def true_vet(self) -> float:
        return float((self.true_ei + self.true_oc) / self.true_ei)


def simulate_records(
    n: int,
    *,
    base: float = 1e-3,
    base_jitter: float = 0.03,
    ramp: float = 0.10,
    io_frac: float = 0.05,
    io_cost: float = 4e-3,
    overhead_frac: float = 0.15,
    pareto_alpha: float = 1.3,
    overhead_scale: float = 5e-3,
    seed: int = 0,
) -> SimProfile:
    """One task's worth of records.

    base/base_jitter/ramp: the ideal CPU curve i(x) — near-flat with a mild
    deterministic ramp (the paper's i(x) is drawn slightly increasing).
    io_frac/io_cost: fraction of records that pay an unavoidable disk access.
    overhead_frac/pareto_alpha/overhead_scale: the reducible heavy tail
    (alpha ~ 1.3 as measured by the paper).
    """
    rng = np.random.default_rng(seed)
    jitter = rng.normal(0.0, base_jitter * base, n).clip(-0.5 * base, None)
    ramp_part = base * ramp * np.linspace(0.0, 1.0, n)
    cpu = base + jitter + ramp_part

    io_mask = rng.random(n) < io_frac
    io = np.where(io_mask, io_cost * (0.8 + 0.4 * rng.random(n)), 0.0)

    ov_mask = rng.random(n) < overhead_frac
    ov = np.where(ov_mask, overhead_scale * rng.pareto(pareto_alpha, n), 0.0)

    ideal = cpu + io
    times = ideal + ov
    return SimProfile(
        times=times,
        ideal=ideal,
        overhead=ov,
        true_ei=float(ideal.sum()),
        true_oc=float(ov.sum()),
    )


def simulate_job(
    n_tasks: int,
    records_per_task: int,
    *,
    utilization_factor: float = 1.0,
    seed: int = 0,
    **kwargs,
) -> list:
    """A job = several tasks from the same population.  ``utilization_factor``
    scales only the *overhead* channel (more slots sharing the core => more
    reducible overhead => higher vet, constant EI — the Table 2 mechanism)."""
    profiles = []
    for i in range(n_tasks):
        kw = dict(kwargs)
        kw["overhead_scale"] = kw.get("overhead_scale", 5e-3) * utilization_factor
        kw["overhead_frac"] = min(
            0.95, kw.get("overhead_frac", 0.15) * max(1.0, utilization_factor ** 0.5)
        )
        profiles.append(simulate_records(records_per_task, seed=seed * 1000 + i, **kw))
    return profiles
