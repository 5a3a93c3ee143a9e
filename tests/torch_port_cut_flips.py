"""Measure where the PyTorch port's change-point differs from the JAX
reference's, on the CPU, and what each differing cut costs.

For each estimator setting it vets the same simulator rows (numpy, seeded)
through ``repro.engine.VetEngine("jax")`` and
``repro_torch.engine.VetEngine("torch", device="cpu")`` and prints one JSON
line: rows, cut flips, the largest relative SSE gap between the two cuts on
the reference's own landscape, how many flips move vet by more than 2%, and
the largest relative difference between the port's vet and the reference
pipeline evaluated at the port's cut.

Usage: ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_port_cut_flips.py``
(a measurement, not a test: pytest does not collect it).
"""

from __future__ import annotations

import json

import numpy as np

import jax.numpy as jnp

from repro.core.changepoint import two_segment_sse
from repro.core.vet import vet_pipeline
from repro.engine import VetEngine as RefEngine
from repro.profiling import simulate_records
from repro_torch.engine import VetEngine

SETTINGS = [(1000, 4000), (1000, 8192), (64, 512), (64, 1024), (None, 256),
            (None, 1024)]


def curve(row, buckets, cut_space):
    y = np.sort(row.astype(np.float32))
    per = 1
    if buckets is not None and y.size >= 4 * buckets:
        per = y.size // buckets
        y = y[:per * buckets].reshape(buckets, per).mean(axis=1,
                                                         dtype=np.float32)
    return (np.log(y) if cut_space == "log" else y), per


def main(rows: int = 200, seed: int = 1) -> None:
    for buckets, n in SETTINGS:
        m = np.stack([simulate_records(n, seed=seed + i).times
                      for i in range(rows)])
        for cut_space in ("log", "raw"):
            ref = RefEngine("jax", buckets=buckets,
                            cut_space=cut_space).vet_batch(m)
            got = VetEngine("torch", buckets=buckets, cut_space=cut_space,
                            device="cpu").vet_batch(m)
            flips = np.flatnonzero(got.t != ref.t)
            gaps, at_cut = [], []
            for i in flips:
                z, per = curve(m[i], buckets, cut_space)
                sse = np.asarray(two_segment_sse(jnp.asarray(z)), np.float64)
                a, b = sse[got.t[i] // per - 1], sse[ref.t[i] // per - 1]
                gaps.append(abs(a - b) / abs(b))
                tb = int(got.t[i]) // per
                vet = float(vet_pipeline(
                    jnp.asarray(m[i]), buckets=buckets, cut_space=cut_space,
                    changepoint_fn=lambda z, omega, tb=tb: jnp.int32(tb))[0])
                at_cut.append(abs(got.vet[i] - vet) / vet)
            spread = np.abs(got.vet[flips] - ref.vet[flips]) / ref.vet[flips]
            print(json.dumps({
                "buckets": buckets, "n": n, "cut_space": cut_space,
                "rows": rows, "cut_flips": int(flips.size),
                "max_gap": max(gaps, default=0.0),
                "flips_vet_over_2pct": int((spread > 0.02).sum()),
                "max_vet_spread": float(spread.max(initial=0.0)),
                "max_rel_err_vet_at_port_cut": max(at_cut, default=0.0)}))


if __name__ == "__main__":
    main()
