"""The differential contract between ``repro_torch`` and ``repro``.

Imported by the ``tests/test_torch_*.py`` suites.  On the CPU the port's
gather path adds its prefix sums and rounds its log in XLA's order
(``xla_order_cumsum``, ``xla_order_log``), so its cuts are the reference's;
the fused window-vet path (a block scan, as on the card) does not, so its
change-point may move between statistical near-ties.  The contract:

- where the cut ``t`` agrees, vet/ei/oc/pr agree to ``RTOL`` (1e-5): the
  same f32 pipeline, with sums taken in another order;
- where it differs, the reference's own SSE landscape puts the two cuts
  within ``GAP`` (1e-4) relative of each other, and the port's vet/ei/oc
  equal the reference pipeline evaluated at the port's cut to ``RTOL``;
- on noiseless two-segment rows the cut is identical (callers assert it).

vet is NOT held within 2% across a cut flip: the extrapolation slope is a
local difference at the cut, so two near-tie cuts can give vets 25-75%
apart on heavy-tailed rows (``tests/torch_port_cut_flips.py`` measures it).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from repro.core.changepoint import two_segment_sse as ref_two_segment_sse
from repro.core.vet import vet_pipeline as ref_vet_pipeline

RTOL = 1e-5
GAP = 1e-4
FIELDS = ("vet", "ei", "oc", "pr")


def curve(times, buckets=None, cut_space="log"):
    """``(z, per)``: the sorted (bucketed, logged) curve the reference's
    ``_cut_and_slope`` takes its cut on, and the records per curve point."""
    y = np.sort(np.asarray(times, np.float32))
    per = 1
    if buckets is not None and y.size >= 4 * buckets:
        per = y.size // buckets
        y = y[:per * buckets].reshape(buckets, per).mean(axis=1,
                                                         dtype=np.float32)
    if cut_space == "log":
        y = np.log(np.maximum(y, np.float32(1e-12)))
    return y, per


def cut_gap(z, t_a: int, t_b: int, omega: int = 3) -> float:
    """Relative gap between cuts ``t_a`` and ``t_b`` (1-indexed on the
    curve) on the reference's landscape of the sorted curve ``z``."""
    sse = np.asarray(ref_two_segment_sse(jnp.asarray(z), omega=omega),
                     np.float64)
    a, b = sse[t_a - 1], sse[t_b - 1]
    return abs(a - b) / max(abs(b), 1e-30)


def ref_at_cut(times, t: int, buckets=None, cut_space="log", omega=3):
    """The reference pipeline on raw ``times`` with its cut forced to record
    rank ``t``: ``(vet, ei, oc)`` as floats."""
    _, per = curve(times, buckets, cut_space)
    tb = jnp.int32(int(t) // per)
    vet, ei, oc, _, t_ref = ref_vet_pipeline(
        jnp.asarray(times), omega=omega, buckets=buckets, cut_space=cut_space,
        changepoint_fn=lambda z, omega: tb)
    assert int(t_ref) == int(t)
    return float(vet), float(ei), float(oc)


def assert_contract(got, ref, times_of, buckets=None, cut_space="log",
                    context: str = "") -> int:
    """Hold per-row results ``got`` (the port) to ``ref`` (the reference).

    ``got``/``ref`` have ``vet``/``ei``/``oc``/``pr``/``t`` fields (a
    ``BatchVetResult`` or a dict); ``times_of(i)`` gives row ``i``'s raw
    record times.  Returns the number of rows whose cut differs.
    """
    def field(res, name):
        v = res[name] if isinstance(res, dict) else getattr(res, name)
        return np.atleast_1d(np.asarray(v, np.float64))

    t_got, t_ref = field(got, "t").astype(int), field(ref, "t").astype(int)
    assert t_got.shape == t_ref.shape, context
    same = t_got == t_ref
    for name in FIELDS:
        a, b = field(got, name), field(ref, name)
        assert np.all(np.isfinite(a)), f"{context}: non-finite {name}"
        np.testing.assert_allclose(a[same], b[same], rtol=RTOL, atol=1e-12,
                                   err_msg=f"{context}: {name}")
    for i in np.flatnonzero(~same):
        times = times_of(int(i))
        z, per = curve(times, buckets, cut_space)
        gap = cut_gap(z, t_got[i] // per, t_ref[i] // per)
        assert gap <= GAP, (f"{context}: row {i} cut {t_got[i]} vs "
                            f"{t_ref[i]} with SSE gap {gap:.3g}")
        want = ref_at_cut(times, t_got[i], buckets, cut_space)
        have = [field(got, name)[i] for name in ("vet", "ei", "oc")]
        np.testing.assert_allclose(have, want, rtol=RTOL, atol=1e-12,
                                   err_msg=f"{context}: row {i} at its cut")
    return int((~same).sum())


def sim_matrix(rows: int, n: int, seed: int = 0) -> np.ndarray:
    """Simulator rows made with numpy from a seed (the reference's
    ``simulate_records``, which the port reproduces bitwise)."""
    from repro.profiling import simulate_records
    return np.stack([simulate_records(n, seed=seed + i).times
                     for i in range(rows)])


def noiseless_matrix(workers: int = 4, window: int = 256, k: int = 160):
    """Exact two-segment piecewise-linear rows (``tests/test_vet_engine.py``):
    an unambiguous change-point."""
    rows = []
    for w in range(workers):
        base = 1.0 + 0.001 * (w + 1) * np.arange(k)
        tail = base[-1] + 0.5 * (w + 1) * np.arange(1, window - k + 1)
        rows.append(np.concatenate([base, tail]))
    return np.stack(rows)
