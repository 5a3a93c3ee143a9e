"""Card-only checks: each CUDA kernel against its plain PyTorch version on
the same CUDA tensors, and the ``cuda`` engine against the ``torch``
engine.  Marked ``gpu``; each test skips (inside the ``cuda`` fixture) when
no CUDA device is present.  Run on a card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.

Tolerances: the change-point kernel's landscape equals the plain version's
to 1e-5 relative (the same f32 operations, no contraction); windows whose
cut agrees agree to 1e-5; a differing cut must be a near-tie (1e-4 relative
on the plain landscape).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.changepoint import two_segment_sse
from repro_torch.engine import VetEngine
from repro_torch.kernels.changepoint import ops as cp
from repro_torch.kernels.windowvet import ops as wv
from repro_torch.profiling import simulate_records

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rows(n_rows, n, seed=0):
    return np.stack([simulate_records(n, seed=seed + i).times
                     for i in range(n_rows)])


def near_tie(z, a, b):
    sse = two_segment_sse(torch.as_tensor(z, dtype=torch.float32)).double()
    return abs(sse[a - 1] - sse[b - 1]) / abs(sse[b - 1]) <= 1e-4


@pytest.mark.parametrize("n_rows,n", [(64, 1000), (1, 8192), (256, 64)])
def test_changepoint_kernel_matches_plain(cuda, n_rows, n):
    z = np.log(np.sort(rows(n_rows, n), axis=1)).astype(np.float32)
    ops_in = cp.prefix_inputs(torch.from_numpy(z).to(cuda))
    before = cp.LAUNCHES
    sse_k, t_k = cp.sse_scan(*ops_in)
    sse_p, t_p = cp.sse_scan_plain(*ops_in)
    assert cp.LAUNCHES == before + 1
    fin = torch.isfinite(sse_p)
    assert torch.equal(fin, torch.isfinite(sse_k))
    torch.testing.assert_close(sse_k[fin], sse_p[fin], rtol=1e-5, atol=0)
    for i in torch.nonzero(t_k != t_p).flatten().tolist():
        assert near_tie(z[i], int(t_k[i]), int(t_p[i]))


@pytest.mark.parametrize("lengths", [np.tile([64, 128, 192], 100),
                                     np.arange(2, 4001, 97),
                                     np.tile([2, 3, 4, 5], 4)],
                         ids=["ragged", "long", "degenerate"])
def test_windowvet_kernel_matches_plain(cuda, lengths):
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    arena = rows(1, int(lengths.sum()), seed=3)[0]
    tensors, lmax, _, _ = wv.launch_inputs(arena, starts, lengths, cuda)
    before = wv.LAUNCHES
    got = wv.fused_window_vet_scan(*tensors, lmax=lmax)[:lengths.size].cpu()
    want = wv.fused_window_vet_plain(*tensors, lmax=lmax)[:lengths.size].cpu()
    assert wv.LAUNCHES == before + 1
    same = got[:, 4] == want[:, 4]
    torch.testing.assert_close(got[same], want[same], rtol=1e-5, atol=0)
    for i in torch.nonzero(~same).flatten().tolist():
        w = np.sort(arena[starts[i]:starts[i] + lengths[i]])
        assert near_tie(np.log(w), int(got[i, 4]), int(want[i, 4]))


def test_cuda_engine_matches_torch_engine(cuda):
    m = rows(32, 4096, seed=9)
    got = VetEngine("cuda", buckets=64).vet_batch(m)
    want = VetEngine("torch", buckets=64).vet_batch(m)
    same = got.t == want.t
    np.testing.assert_allclose(got.vet[same], want.vet[same], rtol=1e-5)
    for i in np.flatnonzero(~same):  # bucketed: 64 records per curve point
        curve = np.sort(m[i].astype(np.float32)).reshape(64, 64).mean(axis=1)
        assert near_tie(np.log(curve), got.t[i] // 64, want.t[i] // 64)
