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


# ------------------------------------------------------------------- SSD
SSD_CASES = {
    # name: (shape (B,T,H,P,N), dtype of x/B/C, chunk, tolerance)
    "serve_f32": ((4, 512, 24, 64, 128), torch.float32, 64, 2e-4),
    "serve_bf16": ((4, 512, 24, 64, 128), torch.bfloat16, 64, 5e-2),
    "reduced_f32": ((2, 64, 16, 16, 16), torch.float32, 8, 2e-4),
    "chunk32": ((2, 256, 4, 64, 128), torch.float32, 32, 2e-4),
}


def ssd_inputs(shape, dtype, dev, seed=0):
    b, t, h, p, n = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, t, h, p), generator=g).to(dev, dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, t, h), generator=g))
    a_log = torch.log(torch.linspace(1.0, 8.0, h))
    bb = torch.randn((b, t, n), generator=g).to(dev, dtype)
    cc = torch.randn((b, t, n), generator=g).to(dev, dtype)
    return x, dt.to(dev), a_log.to(dev), bb, cc, torch.ones(h, device=dev)


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_kernel_matches_plain(cuda, case):
    """Kernel against the plain version on the same CUDA tensors (TestSSD's
    tolerances), and chunk 32 against chunk 64 where the case asks."""
    from repro_torch.kernels.ssd import ops as sd
    from repro_torch.kernels.ssd.ref import ssd_scan_plain
    shape, dtype, chunk, tol = SSD_CASES[case]
    x, dt, a_log, bb, cc, d = ssd_inputs(shape, dtype, cuda)
    a_neg = -torch.exp(a_log)
    before = sd.LAUNCHES
    y = sd.ssd_scan(x, dt, a_neg, bb, cc, d, chunk=chunk)
    assert sd.LAUNCHES == before + 1 and y.dtype == dtype
    want = ssd_scan_plain(x, dt, a_neg, bb, cc, d, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)
    if chunk == 32:
        y64 = sd.ssd_scan(x, dt, a_neg, bb, cc, d, chunk=64)
        torch.testing.assert_close(y, y64, rtol=tol, atol=tol)


def test_ssd_kernel_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels.ssd import ops as sd
    x, dt, a_log, bb, cc, d = ssd_inputs((1, 64, 2, 16, 16), torch.float32,
                                         cuda)
    a_neg = -torch.exp(a_log)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        sd.ssd_scan(x, dt, a_neg, bb, cc, d, chunk=48)
    with pytest.raises(ValueError, match="chunk a multiple of 4 up to"):
        sd.ssd_scan(x, dt, a_neg, bb, cc, d, chunk=2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sd.ssd_scan(x.half(), dt, a_neg, bb.half(), cc.half(), d, chunk=16)
    with pytest.raises(TypeError, match="dt must be"):
        sd.ssd_scan(x, dt.double(), a_neg, bb, cc, d, chunk=16)


def test_mamba_prefill_kernel_matches_plain_path(cuda):
    """The reduced mamba2-130m's prefill through the kernel against the
    plain SSD path on the same card and weights."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ops as sd
    from repro_torch.launch.serve import serve_inputs
    from repro_torch.models import init_cache, prefill
    cfg = get_config("mamba2-130m").reduced()
    params, prompts = serve_inputs(cfg, batch=2, prompt_len=64, seed=1,
                                   dtype=torch.float32, device=cuda)
    cache = init_cache(cfg, 2, 64, device=cuda)
    before = sd.LAUNCHES
    got, _ = prefill(cfg, params, cache, {"tokens": prompts})
    assert sd.LAUNCHES == before + cfg.num_layers
    want, _ = prefill(cfg, params, cache, {"tokens": prompts}, plain=True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
