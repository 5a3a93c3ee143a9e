"""Scalar reference for the fused window-vet kernel (the ladder's root).

A plain host loop of the port's ``core.vet.vet_pipeline`` over the
requested windows: no batching, no kernel, no shared prefix sums.
"""

from __future__ import annotations

import numpy as np

from ...core.vet import vet_pipeline

__all__ = ["ref_window_vet"]


def ref_window_vet(arena, starts, lengths, *, omega: int = 3,
                   buckets=None, cut_space: str = "log"):
    """Vet each window ``arena[starts[r] : starts[r] + lengths[r]]``.

    Returns ``(vet, ei, oc, pr, t, n)`` host arrays in row order.
    """
    arena = np.asarray(arena, dtype=np.float64)
    starts = np.asarray(starts, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    out = {k: [] for k in ("vet", "ei", "oc", "pr", "t")}
    for s, ln in zip(starts, lengths):
        vet, ei, oc, pr, t = vet_pipeline(arena[s:s + ln], omega=omega,
                                          buckets=buckets,
                                          cut_space=cut_space)
        out["vet"].append(float(vet))
        out["ei"].append(float(ei))
        out["oc"].append(float(oc))
        out["pr"].append(float(pr))
        out["t"].append(int(t))
    return (np.asarray(out["vet"]), np.asarray(out["ei"]),
            np.asarray(out["oc"]), np.asarray(out["pr"]),
            np.asarray(out["t"], dtype=np.int32),
            lengths.astype(np.int64))
