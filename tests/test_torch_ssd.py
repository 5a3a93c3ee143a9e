"""The port's SSD scan (``repro_torch.kernels.ssd``) against the reference's
on the same inputs: ``repro.kernels.ssd.ref.ssd_ref`` (the stepwise
oracle) and ``repro.models.layers._ssd_chunked`` in its vectorised and
``sequential=True`` forms.  On CPU tensors ``ops.ssd`` runs the plain
version, so this holds the plain version, the wrapper's argument handling
and the port's own stepwise oracle.

Inputs are TestSSD's (``tests/test_kernels.py``), made with numpy from a
seed; tolerances are that suite's: 2e-4 (rtol and atol) in f32, 5e-2 with
bf16 x/B/C, 2e-4 between chunk sizes 32 and 64 (the state carried across
chunks).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro.models.layers import _ssd_chunked
from repro_torch.kernels.ssd import ssd, ssd_ref, ssd_scan_plain


def make_inputs(b, t, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 8.0, h)).astype(np.float32)
    bb = rng.standard_normal((b, t, n)).astype(np.float32)
    cc = rng.standard_normal((b, t, n)).astype(np.float32)
    d = np.ones(h, np.float32)
    return x, dt, a_log, bb, cc, d


CASES = {
    # name: (shape (B,T,H,P,N), dtype of x/B/C, chunks, tolerance)
    "f32_reduced": ((2, 64, 4, 16, 16), "float32", (8,), 2e-4),
    "f32_chunk16": ((1, 96, 3, 32, 16), "float32", (16,), 2e-4),
    "bf16": ((1, 128, 2, 32, 16), "bfloat16", (64,), 5e-2),
    "chunk32_vs_64": ((1, 256, 2, 32, 16), "float32", (32, 64), 2e-4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssd_matches_reference(case):
    shape, dtype, chunks, tol = CASES[case]
    x, dt, a_log, bb, cc, d = make_inputs(*shape, seed=len(case))
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jx, jb, jc = (jnp.asarray(v).astype(jdt) for v in (x, bb, cc))
    tx, tb, tc = (torch.from_numpy(v).to(tdt) for v in (x, bb, cc))
    jargs = (jx, jnp.asarray(dt), jnp.asarray(a_log), jb, jc, jnp.asarray(d))
    targs = (tx, torch.from_numpy(dt), torch.from_numpy(a_log), tb, tc,
             torch.from_numpy(d))

    oracle = np.asarray(jax_ssd_ref(*jargs), np.float32)
    port_oracle = ssd_ref(*targs)
    assert port_oracle.dtype == tdt
    np.testing.assert_allclose(port_oracle.float().numpy(), oracle,
                               rtol=tol, atol=tol)
    outs = []
    for chunk in chunks:
        got = ssd(*targs, chunk=chunk)
        assert got.dtype == tdt and tuple(got.shape) == shape[:4]
        got = got.float().numpy()
        for want in (oracle,
                     np.asarray(_ssd_chunked(*jargs, chunk), np.float32),
                     np.asarray(_ssd_chunked(*jargs, chunk, sequential=True),
                                np.float32)):
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        outs.append(got)
    for other in outs[1:]:
        np.testing.assert_allclose(other, outs[0], rtol=tol, atol=tol)


def test_ssd_refuses_a_ragged_chunk():
    x, dt, a_log, bb, cc, d = (torch.from_numpy(v)
                               for v in make_inputs(1, 12, 2, 8, 8))
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ssd(x, dt, a_log, bb, cc, d, chunk=8)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ssd_scan_plain(x, dt, -torch.exp(a_log), bb, cc, d, chunk=8)
