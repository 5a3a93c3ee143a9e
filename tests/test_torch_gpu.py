"""Card-only checks: each CUDA kernel against its plain PyTorch version on
the same CUDA tensors, and the ``cuda`` engine against the ``torch``
engine.  Marked ``gpu``; each test skips (inside the ``cuda`` fixture) when
no CUDA device is present.  Run on a card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.

Tolerances: the change-point kernel's cuts and landscape equal the plain
twin's exactly (the same f32 operations in the same order, no
contraction); the window-vet kernel's cuts equal the plain version's on
every row, its other lanes agree to 1e-5, and a row's lanes are the same
alone and padded to 4096.  SSD and flash attention take the reference
suite's tolerances (tests/test_kernels.py): SSD 2e-4 in f32 and 5e-2 in
bf16, attention 2e-5 in f32 and 2e-2 in bf16, the wide entries (D
136-256, V at its own width) too, and MLA's V at 128 bit for bit the first
columns of the same call on V zero-padded to 192, the padded ones exactly
0; model prefill logits 1e-4, the
reduced MLA and hybrid models' caches too, MLA's routing under the
routing contract.
Gradients through the kernels' autograd routes: each input gradient within
1e-4 of its largest plain-autograd gradient (the routes' backward is the
plain version's, so the two differ only where the saved inputs do: not at
all); a reduced model's training loss through the kernels within 1e-5
relative of ``plain=True`` and each parameter's gradient within 1e-3 of
its largest (the smoke's ``LOGIT_TOL`` basis).  The reduced MoE model's
prefill on the card against the CPU: each token's experts and each
expert's tokens equal, or a flip at a near-tie (1e-4 relative under the
CPU's own values, forced to the card's routing, against which the card is
then held), logits and caches 1e-4; two card prefills equal bit for bit.
One reduced hubert-xlarge train step on the card against the CPU: loss and
gradient norm 1e-5 relative, first moments 1e-3 of each leaf's largest,
``embed``'s exactly zero.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.changepoint import two_segment_sse
from repro_torch.engine import VetEngine
from repro_torch.fleet import VetMux
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


CHANGEPOINT_CASES = {
    # name: lengths of the rows (ragged, packed end to end)
    "ragged_6_64": np.random.default_rng(5).integers(6, 65, 4096),
    "job_1024x1000": np.full(1024, 1000),
    "one_8192": np.array([8192]),
    "one_65536_global_scratch": np.array([65536]),
}


@pytest.mark.parametrize("case", sorted(CHANGEPOINT_CASES))
def test_changepoint_kernel_matches_plain(cuda, case):
    """The kernel's cuts and landscape equal the plain twin's bit for bit
    (the same f32 operations in the same order, no contraction)."""
    lengths = CHANGEPOINT_CASES[case]
    groups = [np.log(np.sort(rows(1, int(n), seed=i)[0]))[None]
              for i, n in enumerate(lengths)]
    (values, starts, lengths_t), span = cp.pack_rows(groups, cuda)
    assert (cp.scan_floats(span[1]) > cp.SHARED_FLOATS) == \
        case.endswith("global_scratch")
    before = cp.LAUNCHES
    t_k, sse_k = cp.changepoint_ragged(values, starts, lengths_t,
                                       landscape=True, span=span)
    t_p, sse_p = cp.changepoint_ragged_plain(values, starts, lengths_t,
                                             landscape=True)
    assert cp.LAUNCHES == before + 1
    assert torch.equal(t_k, t_p)
    assert torch.equal(sse_k, sse_p)
    dense = values.reshape(-1, int(lengths[0])) if np.all(
        lengths == lengths[0]) else None
    if dense is not None:  # the dense entries take the same kernel
        assert torch.equal(cp.changepoint_cuda(dense), t_k)
        assert torch.equal(cp.two_segment_sse_cuda(dense).flatten(), sse_k)


def test_changepoint_kernel_refuses_short_rows(cuda):
    y = torch.linspace(0.0, 1.0, 5, device=cuda)
    with pytest.raises(ValueError, match="2\\*omega"):
        cp.changepoint_cuda(y)
    (values, starts, lengths), span = cp.pack_rows(
        [np.ones((2, 8)), np.ones((1, 5))], cuda)
    with pytest.raises(ValueError, match="2\\*omega"):
        cp.changepoint_ragged(values, starts, lengths, span=span)


def test_cuda_mux_tick_makes_one_changepoint_launch(cuda):
    """Every due ring of a monitored tick goes through one launch."""
    mux = VetMux(VetEngine("cuda", buckets=64))
    assert mux.monitor.method == "cuda"
    for i in range(64):
        mux.register(i, window=64, stride=32)
    m = rows(64, 64 * 8, seed=11)
    for k in range(8):
        for i in range(64):
            mux.feed(i, m[i, 64 * k:64 * (k + 1)])
        before = (cp.LAUNCHES, wv.LAUNCHES)
        mux.tick()
        # one fused windowvet launch; from tick 4 on the rings hold >= 6
        # windows and the monitor scans them all in one launch
        assert (cp.LAUNCHES - before[0], wv.LAUNCHES - before[1]) == \
            ((1 if k >= 3 else 0), 1)


WINDOWVET_CASES = {
    # name: lengths of the rows, packed end to end (lmax = pow2(longest))
    "ragged": np.tile([64, 128, 192], 100),  # warp path, lmax 256
    "degenerate": np.tile([2, 3, 4, 5], 4),  # warp path, lmax 8
    "warp_lmax32": np.arange(2, 33),  # one value per lane
    "warp_lmax512": np.random.default_rng(3).integers(2, 513, 300),
    "block_lmax1024": np.random.default_rng(4).integers(2, 1025, 300),
    "long": np.arange(2, 4001, 97),  # block path, lmax 4096
}


@pytest.mark.parametrize("case", sorted(WINDOWVET_CASES))
def test_windowvet_kernel_matches_plain(cuda, case):
    """Every row's cut equals the plain version's, and the other lanes
    agree to 1e-5 (the same f32 operations in the same order: they are
    expected bit for bit), on both paths and at the limit between them."""
    lengths = WINDOWVET_CASES[case]
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    arena = rows(1, int(lengths.sum()), seed=3)[0]
    tensors, lmax, _, _ = wv.launch_inputs(arena, starts, lengths, cuda)
    assert lmax == max(8, 1 << int(lengths.max() - 1).bit_length())
    before = wv.LAUNCHES
    got = wv.fused_window_vet_scan(*tensors, lmax=lmax)[:lengths.size].cpu()
    want = wv.fused_window_vet_plain(*tensors, lmax=lmax)[:lengths.size].cpu()
    assert wv.LAUNCHES == before + 1
    assert torch.equal(got[:, 4], want[:, 4])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n", [2, 33, 100, 256, 512, 700, 2049])
def test_windowvet_row_alone_equals_the_row_padded_to_4096(cuda, n):
    """A row vetted alone (lmax = pow2(n), the warp path up to 512) gives
    the same lanes as in a launch padded to 4096 (the block path)."""
    arena = rows(1, 3 * wv.MAX_LMAX, seed=5)[0]
    alone, lmax1, _, _ = wv.launch_inputs(arena, [17], [n], cuda)
    padded, lmax2, _, _ = wv.launch_inputs(arena, [17, 0], [n, wv.MAX_LMAX],
                                           cuda)
    assert lmax2 == wv.MAX_LMAX
    a = wv.fused_window_vet_scan(*alone, lmax=lmax1)[0].cpu()
    b = wv.fused_window_vet_scan(*padded, lmax=lmax2)[0].cpu()
    assert torch.equal(a, b), (a, b)


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
    # P, N and the chunk multiples of 4 but not of 8 or 16: padded edges
    "odd_p12_n20_c12": ((2, 96, 3, 12, 20), torch.float32, 12, 2e-4),
    "odd_p12_n20_c12_bf16": ((2, 96, 3, 12, 20), torch.bfloat16, 12, 5e-2),
    # four blocks a head (P = 128), eight pieces of the state, chunk 48
    "p128_n256_c48": ((1, 96, 2, 128, 256), torch.float32, 48, 2e-4),
    # the widest state the SIMT kernel before this one took (4 rows, 150
    # pieces), and the widest at P = 64 now
    "p4_n4800_c4": ((1, 32, 2, 4, 4800), torch.float32, 4, 2e-4),
    "p64_n1248_c64": ((1, 128, 2, 64, 1248), torch.float32, 64, 2e-4),
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


# (B, T, H, P, N, groups), dtype, chunk, tolerance
SSD_GROUPED_CASES = {
    # zamba2-7b-instruct's mixer on a short prompt: 112 heads, 2 groups
    "zamba2_g2": ((1, 256, 112, 64, 64, 2), torch.float32, 64, 2e-4),
    "g4_odd_p12_n20_c12": ((2, 96, 8, 12, 20, 4), torch.float32, 12, 2e-4),
    "g2_bf16": ((2, 128, 4, 64, 128, 2), torch.bfloat16, 64, 5e-2),
}


@pytest.mark.parametrize("case", sorted(SSD_GROUPED_CASES))
def test_ssd_kernel_groups_and_final_state(cuda, case):
    """B and C in groups, each head reading its own group's, and the f32
    state the scan carries at its end, against the plain version (the
    state to the tolerance of its largest); y the same with and without
    the state written."""
    from repro_torch.kernels.ssd import ops as sd
    from repro_torch.kernels.ssd.ref import ssd_scan_plain
    (b, t, h, p, n, g), dtype, chunk, tol = SSD_GROUPED_CASES[case]
    x, dt, a_log, _, _, d = ssd_inputs((b, t, h, p, n), dtype, cuda)
    gen = torch.Generator().manual_seed(1)
    bb = torch.randn((b, t, g, n), generator=gen).to(cuda, dtype)
    cc = torch.randn((b, t, g, n), generator=gen).to(cuda, dtype)
    a_neg = -torch.exp(a_log)
    y, state = sd.ssd_scan(x, dt, a_neg, bb, cc, d, chunk=chunk,
                           final_state=True)
    want, s_want = ssd_scan_plain(x, dt, a_neg, bb, cc, d, chunk=chunk,
                                  final_state=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)
    assert state.shape == (b, h, p, n) and state.dtype == torch.float32
    assert (state - s_want).abs().max() <= tol * s_want.abs().max()
    assert torch.equal(sd.ssd_scan(x, dt, a_neg, bb, cc, d, chunk=chunk), y)


def test_ssd_smem_copy_matches_the_library(cuda):
    """``ops.smem_bytes`` against the built library's own
    ``ssd_scan_smem_bytes`` (``ssd_smem`` of ``csrc/ssd.cu``)."""
    from repro_torch.kernels import runtime
    from repro_torch.kernels.ssd import ops as sd
    lib = runtime.load_library()
    for p in (4, 12, 16, 20, 64, 128):
        for n in (4, 16, 20, 128, 256, 1248, 4800):
            for chunk in (4, 8, 12, 32, 48, 64):
                for dtype, esize in ((torch.float32, 4), (torch.bfloat16, 2)):
                    assert lib.ssd_scan_smem_bytes(p, n, chunk, esize) == \
                        sd.smem_bytes(p, n, chunk, dtype), (p, n, chunk, dtype)


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
    wide = ssd_inputs((1, 64, 2, 32, 1280), torch.float32, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        sd.ssd_scan(wide[0], wide[1], -torch.exp(wide[2]), *wide[3:], chunk=64)


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


# ------------------------------------------------------- flash attention
FLASH_CASES = {
    # name: ((B, S, H, KH, D), causal, window, dtype, tolerance)
    "swa_gqa_d120_f32": ((2, 520, 32, 8, 120), True, 256, torch.float32, 2e-5),
    "swa_gqa_d120_bf16": ((2, 520, 32, 8, 120), True, 256, torch.bfloat16,
                          2e-2),
    "causal_d64": ((1, 300, 8, 2, 64), True, 0, torch.float32, 2e-5),
    "bidirectional_d128": ((1, 256, 4, 4, 128), False, 0, torch.float32,
                           2e-5),
    "ragged_200": ((1, 200, 4, 4, 64), True, 0, torch.float32, 2e-5),
    "window_not_causal": ((1, 256, 4, 2, 32), False, 64, torch.float32, 2e-5),
    "tiny_d8_mqa": ((2, 70, 4, 1, 8), True, 5, torch.float32, 2e-5),
    # the tensor-core kernels' edges: D = 128 at H / KH = 4, S below one
    # 128-row tile, D = 8 (all but 8 of the 128 bf16 columns zero-filled),
    # a window that is no multiple of either tile, one query, H = KH, and
    # the bf16 kernel's non-causal masks
    "gqa4_d128_bf16": ((1, 384, 8, 2, 128), True, 0, torch.bfloat16, 2e-2),
    "ragged_200_bf16": ((1, 200, 4, 4, 64), True, 0, torch.bfloat16, 2e-2),
    "tiny_d8_mqa_bf16": ((2, 70, 4, 1, 8), True, 5, torch.bfloat16, 2e-2),
    "window_100_f32": ((2, 600, 8, 2, 64), True, 100, torch.float32, 2e-5),
    "window_100_bf16": ((2, 600, 8, 2, 64), True, 100, torch.bfloat16,
                        2e-2),
    "single_query_f32": ((2, 1, 4, 2, 32), True, 0, torch.float32, 2e-5),
    "single_query_bf16": ((2, 1, 4, 2, 32), True, 0, torch.bfloat16, 2e-2),
    "mha_d120_bf16": ((1, 256, 4, 4, 120), True, 0, torch.bfloat16, 2e-2),
    "window_not_causal_bf16": ((1, 256, 4, 2, 32), False, 64, torch.bfloat16,
                               2e-2),
    "bidirectional_d128_bf16": ((1, 256, 4, 4, 128), False, 0, torch.bfloat16,
                                2e-2),
    # 16,384 keys in f32: the f32 kernel sums each tile's P V into a zeroed
    # partial added in IEEE f32, so its error must not grow with the keys
    "causal_16k_f32": ((1, 16384, 8, 2, 128), True, 0, torch.float32, 2e-5),
    # the MoE and frontend paths' shapes: hubert-xlarge's bidirectional 16
    # heads of 80 (two 64-column panels, the second one zero-filled past
    # column 16) and internvl2-26b's 48 query heads over 8 KV heads of 128
    "hubert_d80_bidirectional_f32": ((2, 1024, 16, 16, 80), False, 0,
                                     torch.float32, 2e-5),
    "hubert_d80_bidirectional_bf16": ((2, 1024, 16, 16, 80), False, 0,
                                      torch.bfloat16, 2e-2),
    "internvl_gqa48_8_f32": ((1, 2048, 48, 8, 128), True, 0, torch.float32,
                             2e-5),
    "internvl_gqa48_8_bf16": ((1, 2048, 48, 8, 128), True, 0,
                              torch.bfloat16, 2e-2),
}


def flash_inputs(shape, dtype, dev, seed=0):
    b, s, h, kh, d = shape
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(sh, generator=g).to(dev, dtype)
                 for sh in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain(cuda, case):
    """Kernel against the plain version on the same CUDA tensors, at the
    reference suite's tolerances (tests/test_kernels.py)."""
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.flash_attention import ops as fa
    shape, causal, window, dtype, tol = FLASH_CASES[case]
    q, k, v = flash_inputs(shape, dtype, cuda)
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES == before + 1 and got.dtype == dtype
    want = attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# the wide entries (D from 136 to 256, wgmma; V as wide as D here, so D
# above 128 takes two V panels): MLA's 192 at full width, the entries'
# edges 136 and 256, MHA and GQA, causal, windowed (a window that is no
# multiple of the key tiles) and bidirectional, a ragged S, both types
WIDE_FLASH_CASES = {
    "mla_d192_causal_f32": ((2, 512, 16, 16, 192), True, 0, torch.float32,
                            2e-5),
    "mla_d192_causal_bf16": ((2, 512, 16, 16, 192), True, 0, torch.bfloat16,
                             2e-2),
    "d136_gqa_window_f32": ((1, 300, 8, 2, 136), True, 70, torch.float32,
                            2e-5),
    "d136_gqa_window_bf16": ((1, 300, 8, 2, 136), True, 70, torch.bfloat16,
                             2e-2),
    "d256_bidirectional_f32": ((1, 200, 4, 4, 256), False, 0, torch.float32,
                               2e-5),
    "d256_bidirectional_bf16": ((1, 200, 4, 4, 256), False, 0,
                                torch.bfloat16, 2e-2),
    "d192_window_not_causal_f32": ((1, 256, 4, 2, 192), False, 50,
                                   torch.float32, 2e-5),
    "d256_mqa_ragged_f32": ((2, 97, 4, 1, 256), True, 0, torch.float32, 2e-5),
    "d144_single_query_f32": ((2, 1, 4, 2, 144), True, 0, torch.float32,
                              2e-5),
}


@pytest.mark.parametrize("case", sorted(WIDE_FLASH_CASES))
def test_wide_flash_entry_matches_plain(cuda, case):
    """The wide entry against the plain version on the same CUDA tensors:
    one launch, counted in ``LAUNCHES`` and ``WIDE_LAUNCHES``."""
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.flash_attention import ops as fa
    shape, causal, window, dtype, tol = WIDE_FLASH_CASES[case]
    q, k, v = flash_inputs(shape, dtype, cuda)
    before, wide = fa.LAUNCHES, fa.WIDE_LAUNCHES
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert (fa.LAUNCHES, fa.WIDE_LAUNCHES) == (before + 1, wide + 1)
    want = attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# V at its own width on the wide entries: ((B, S, H, KH, D), Dv, causal,
# window, dtype, tolerance).  MLA's 128 of 192; Dv = 8; one panel of 64
# columns; two panels with the second one nearly empty (136 of 256, 200
# of 200)
WIDE_VDIM_CASES = {
    "mla_v128_f32": ((2, 512, 16, 16, 192), 128, True, 0, torch.float32,
                     2e-5),
    "mla_v128_bf16": ((2, 512, 16, 16, 192), 128, True, 0, torch.bfloat16,
                      2e-2),
    "d136_v64_window_f32": ((1, 300, 8, 2, 136), 64, True, 70,
                            torch.float32, 2e-5),
    "d256_v8_mqa_ragged_bf16": ((2, 97, 4, 1, 256), 8, True, 0,
                                torch.bfloat16, 2e-2),
    "two_panels_d256_v136_bidirectional_f32": ((1, 200, 4, 4, 256), 136,
                                               False, 0, torch.float32, 2e-5),
    "two_panels_d256_v136_bidirectional_bf16": ((1, 200, 4, 4, 256), 136,
                                                False, 0, torch.bfloat16,
                                                2e-2),
    "two_panels_d200_v200_f32": ((2, 300, 4, 2, 200), 200, True, 0,
                                 torch.float32, 2e-5),
}


@pytest.mark.parametrize("case", sorted(WIDE_VDIM_CASES))
def test_wide_flash_entry_takes_v_at_its_own_width(cuda, case):
    """The wide entries on V narrower than Q and K, or wider than one
    128-column panel, against the plain version: one wide launch, an
    output of V's width."""
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.flash_attention import ops as fa
    shape, dv, causal, window, dtype, tol = WIDE_VDIM_CASES[case]
    b, s, h, kh, d = shape
    q, k, _ = flash_inputs(shape, dtype, cuda)
    v = torch.randn((b, s, kh, dv), generator=torch.Generator().manual_seed(1)
                    ).to(cuda, dtype)
    wide = fa.WIDE_LAUNCHES
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.WIDE_LAUNCHES == wide + 1
    assert got.shape == (b, s, h, dv) and got.dtype == dtype
    want = attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_refuses_a_v_width_it_cannot_take(cuda, dtype):
    """Both entries take V from 1 column to as wide as Q and K, no wider
    and not empty."""
    from repro_torch.kernels.flash_attention import ops as fa
    for d in (128, 192):
        q, k, v = flash_inputs((1, 64, 4, 2, d), dtype, cuda)
        for bad in (v[..., :0], torch.cat([v, v[..., :8]], -1)):
            with pytest.raises(ValueError, match="V's width"):
                fa.flash_attention(q, k, bad.contiguous())


# V narrower than Q and K where the entry does not take it as it is:
# ((B, S, H, KH, D), Dv, causal, window, dtype, tolerance).  The narrow
# entries take V only at D (the reduced MLA config's 16 of 24; 64 of 128),
# the wide ones a multiple of 8 (60 and 100)
PADDED_V_CASES = {
    "reduced_mla_d24_v16_f32": ((2, 96, 4, 4, 24), 16, True, 0,
                                torch.float32, 2e-5),
    "d128_v64_window_bf16": ((1, 300, 8, 2, 128), 64, True, 70,
                             torch.bfloat16, 2e-2),
    "d120_v60_gqa_f32": ((2, 200, 8, 2, 120), 60, True, 0, torch.float32,
                         2e-5),
    "d192_v60_bf16": ((2, 256, 4, 4, 192), 60, True, 0, torch.bfloat16,
                      2e-2),
    "d136_v100_window_f32": ((1, 300, 8, 2, 136), 100, True, 70,
                             torch.float32, 2e-5),
}


@pytest.mark.parametrize("case", sorted(PADDED_V_CASES))
def test_flash_wrapper_pads_v_to_the_width_its_entry_takes(cuda, case):
    """The wrapper zero-pads V to D (narrow entries) or to a multiple of 8
    (wide entries) and keeps the output's first Dv columns: one launch, an
    output of V's width, the plain attention over that V."""
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.flash_attention import ops as fa
    shape, dv, causal, window, dtype, tol = PADDED_V_CASES[case]
    b, s, h, kh, d = shape
    q, k, _ = flash_inputs(shape, dtype, cuda)
    v = torch.randn((b, s, kh, dv), generator=torch.Generator().manual_seed(2)
                    ).to(cuda, dtype)
    before, wide = fa.LAUNCHES, fa.WIDE_LAUNCHES
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert (fa.LAUNCHES, fa.WIDE_LAUNCHES) == (before + 1,
                                               wide + int(d > 128))
    assert got.shape == (b, s, h, dv) and got.is_contiguous()
    want = attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_narrow_entries_do_not_count_as_wide(cuda):
    from repro_torch.kernels.flash_attention import ops as fa
    q, k, v = flash_inputs((1, 64, 4, 2, 128), torch.float32, cuda)
    before, wide = fa.LAUNCHES, fa.WIDE_LAUNCHES
    fa.flash_attention(q, k, v)
    assert (fa.LAUNCHES, fa.WIDE_LAUNCHES) == (before + 1, wide)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_v_padding_through_the_wide_entry(cuda, dtype):
    """MLA's prefill shape at a short S: Q and K of 192, V of 128.
    ``layers.attention`` hands V to the wide entry at 128: its output is the
    plain attention over that V and, bit for bit, the first 128 columns of
    the same call on V zero-padded to 192 (whose first V panel is formed
    alike, and whose padded columns come out exactly 0); the autograd
    route gives the plain gradients."""
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(3)
    q, k = (torch.randn((2, 256, 16, 192), generator=g).to(cuda, dtype)
            for _ in range(2))
    v = torch.randn((2, 256, 16, 128), generator=g).to(cuda, dtype)
    scale = 192 ** -0.5
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    padded = fa.flash_attention(q, k, torch.nn.functional.pad(v, (0, 64)),
                                scale=scale)
    assert not padded[..., 128:].any()
    wide = fa.WIDE_LAUNCHES
    got = L.attention(q, k, v, scale=scale)
    assert fa.WIDE_LAUNCHES == wide + 1 and got.shape == v.shape
    want = attention_plain(q, k, v, scale=scale)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(got, padded[..., :128], rtol=0, atol=0)
    if dtype == torch.float32:
        w = torch.randn(v.shape, device=cuda)
        _, a = grads_of(lambda *t: L.attention(*t, scale=scale), (q, k, v), w)
        _, b = grads_of(lambda *t: attention_plain(*t, scale=scale),
                        (q, k, v), w)
        for name, x, y in zip("qkv", a, b):
            err = float((x - y).abs().max())
            assert err <= 1e-4 * float(y.abs().max()), name


def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels.flash_attention import ops as fa
    q, k, v = flash_inputs((1, 64, 4, 2, 32), torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple of 8 up to 256"):
        fa.flash_attention(q[..., :28].contiguous(), k[..., :28].contiguous(),
                           v[..., :28].contiguous())
    big = flash_inputs((1, 64, 4, 2, 264), torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple of 8 up to 256"):
        fa.flash_attention(*big)
    wide = flash_inputs((1, 64, 4, 2, 196), torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple of 8 up to 256"):
        fa.flash_attention(*wide)
    with pytest.raises(ValueError, match="not a multiple of KV heads"):
        fa.flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="v must be"):
        fa.flash_attention(q, k, v.double())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)
    with pytest.raises(ValueError, match="window must be"):
        fa.flash_attention(q, k, v, window=-1)


def test_dense_prefill_kernel_matches_plain_path(cuda):
    """The reduced h2o-danube-3-4b's prefill through the kernel against the
    plain attention path on the same card and weights."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.serve import serve_inputs
    from repro_torch.models import init_cache, prefill
    cfg = get_config("h2o-danube-3-4b").reduced()
    params, prompts = serve_inputs(cfg, batch=2, prompt_len=64, seed=1,
                                   dtype=torch.float32, device=cuda)
    before = fa.LAUNCHES
    got, ck = prefill(cfg, params, init_cache(cfg, 2, 64, device=cuda),
                      {"tokens": prompts})
    assert fa.LAUNCHES == before + cfg.num_layers
    want, cp = prefill(cfg, params, init_cache(cfg, 2, 64, device=cuda),
                       {"tokens": prompts}, plain=True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ck["seg0"]["k"], cp["seg0"]["k"], rtol=1e-4,
                               atol=1e-4)


def test_transport_fleet_on_the_card_equals_the_sharded_fleet(cuda):
    """Two spawned shard workers on the card, each with its own CUDA
    context, against the in-process sharded fleet on the same card: the
    same kernels on the same inputs, so rows and flags are equal bit for
    bit; each worker's spans show one fused ``cuda`` dispatch per tick."""
    from repro_torch.fleet import ShardedVetMux, TransportVetMux, build
    from repro_torch.obs import Tracer
    sc = build("mixed_windows", n_workers=12, n_ticks=5, seed=4)
    tracer = Tracer()
    oracle = ShardedVetMux(2, engine=VetEngine("cuda", buckets=64))
    with TransportVetMux(2, engine=VetEngine("cuda", buckets=64),
                         driver="process", tracer=tracer) as fleet:
        for spec in sc.specs:
            spec.register(fleet)
            spec.register(oracle)
        for event in sc.events:
            for sid, chunk in event.chunks.items():
                fleet.feed(sid, chunk)
                oracle.feed(sid, chunk)
            got, ref = fleet.tick(), oracle.tick()
            assert got.serviced == ref.serviced and got.flags == ref.flags
            for sid, r in ref.results.items():
                if r is not None:
                    assert got.results[sid].vet[-1] == r.vet[-1]
                    assert got.results[sid].t[-1] == r.t[-1]
        for sid in fleet.ids():
            a, b = fleet.collect(sid), oracle.stream(sid).collect()
            for name in ("vet", "ei", "oc", "pr", "t", "n"):
                np.testing.assert_array_equal(getattr(a, name),
                                              getattr(b, name))
        assert fleet.stats.respawns == fleet.stats.retries == 0
    fused, launched = {}, {}
    for r in tracer.records:
        attrs = dict(r.attrs)
        if r.name == "engine.dispatch" and r.pid > 0:
            assert (attrs["backend"], attrs["kind"]) == ("cuda", "fused")
            fused[r.pid] = fused.get(r.pid, 0) + 1
        elif r.name == "worker.tick":
            launched[r.pid] = (launched.get(r.pid, 0)
                               + attrs["windowvet_launches"])
    # one fused launch per tick on which the shard had windows to vet,
    # as each worker's own window-vet wrapper counted it
    assert fused == launched == {k + 1: s.dispatches
                                 for k, s in enumerate(oracle.shard_stats)}
    assert all(s.dispatches >= len(sc.events) - 1
               for s in oracle.shard_stats)


def test_tail_on_the_card_equals_the_cpu(cuda):
    """Sorts, ``xla_order_log`` and ``xla_order_cumsum`` are fixed sequences
    of IEEE operations: ``hill_plot`` and ``emplot`` give the CPU's bits on
    the card; ``tail_report`` (means and sums in each device's order)
    agrees to 1e-5."""
    from repro_torch.core import emplot, hill_plot, tail_report
    x = rows(1, 65536, seed=3)[0]
    for fn in (hill_plot, emplot):
        for a, b in zip(fn(x, device=cuda), fn(x, device="cpu")):
            assert torch.equal(a.cpu(), b)
    got, want = tail_report(x, device=cuda), tail_report(x, device="cpu")
    assert got.heavy == want.heavy
    np.testing.assert_allclose(
        [got.alpha, got.emplot_slope, *got.alpha_stable_band],
        [want.alpha, want.emplot_slope, *want.alpha_stable_band], rtol=1e-5)


def test_controller_decide_is_one_windowvet_launch(cuda):
    """``VetController`` on the fused ``cuda`` engine: one window-vet launch
    per ``decide()`` once windows complete, the plain fused fleet's
    decisions and worker vets."""
    from repro_torch.fleet.scenarios import skewed_stragglers
    from repro_torch.sched import VetController
    sc = skewed_stragglers(n_workers=64, window=200, n_ticks=4,
                           straggler_frac=0.1, seed=0)
    ctl = VetController(64, engine=VetEngine("cuda", buckets=64))
    plain = VetController(64, engine=VetEngine("torch", buckets=64,
                                                fused=True))
    for k, event in enumerate(sc.events):
        for sid, chunk in event.chunks.items():
            ctl.feed(int(sid[1:]), chunk)
            plain.feed(int(sid[1:]), chunk)
        before = wv.LAUNCHES
        got, want = ctl.decide(), plain.decide()
        assert wv.LAUNCHES - before == (1 if k > 0 else 0)
        assert (got.target_workers, got.stragglers, got.reason) == \
            (want.target_workers, want.stragglers, want.reason)
        assert got.worker_vets == want.worker_vets


def test_online_vet_launches_the_changepoint_kernel_per_dispatch(cuda):
    from repro_torch.core import OnlineVet
    x = rows(1, 8192, seed=5)[0]
    eng = VetEngine("cuda", buckets=64)
    ov = OnlineVet(window=512, engine=eng)
    before, wv_before = cp.LAUNCHES, wv.LAUNCHES
    snaps = []
    for lo in range(0, x.size, 1024):
        snaps.extend(ov.feed(x[lo:lo + 1024]))
    assert len(snaps) == (8192 - 512) // 256 + 1
    assert cp.LAUNCHES - before == eng.dispatches > 0
    assert wv.LAUNCHES == wv_before


# ------------------------------------------------ gradients through the kernels
def grads_of(fn, inputs, w):
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*ins)
    return out.detach(), torch.autograd.grad((out * w).sum(), ins)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_autograd_route_launches_and_gives_plain_gradients(cuda, dtype):
    """On inputs that require grad the forward launches the kernel once
    (its output within the SSD tolerance of the plain version's) and the
    input gradients are the plain version's autograd to 1e-4 of each
    input's largest gradient."""
    from repro_torch.kernels.ssd import ops as sd
    from repro_torch.kernels.ssd.ref import ssd_scan_plain
    x, dt, a_log, bb, cc, d = ssd_inputs((2, 128, 4, 16, 32), dtype, cuda)
    inputs = (x, dt, -torch.exp(a_log), bb, cc, d)
    w = torch.randn(x.shape, device=cuda).to(dtype)
    before = sd.LAUNCHES
    y, got = grads_of(lambda *t: sd.ssd_scan(*t, chunk=32), inputs, w)
    assert sd.LAUNCHES == before + 1
    y_p, want = grads_of(lambda *t: ssd_scan_plain(*t, chunk=32), inputs, w)
    torch.cuda.synchronize()
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(y.float(), y_p.float(), rtol=tol, atol=tol)
    for name, a, b in zip("x dt a_neg b c d".split(), got, want):
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        assert err <= 1e-4 * scale, f"{name}: {err:.3g} of {scale:.3g}"


def test_flash_autograd_route_launches_and_gives_plain_gradients(cuda):
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.flash_attention import ops as fa
    q, k, v = flash_inputs((2, 256, 8, 2, 64), torch.float32, cuda)
    w = torch.randn(q.shape, device=cuda)
    for window in (0, 100):
        before = fa.LAUNCHES
        _, got = grads_of(lambda *t: fa.flash_attention(*t, window=window),
                          (q, k, v), w)
        assert fa.LAUNCHES == before + 1
        _, want = grads_of(lambda *t: attention_plain(*t, window=window),
                           (q, k, v), w)
        torch.cuda.synchronize()
        for name, a, b in zip("qkv", got, want):
            scale = float(b.abs().max())
            err = float((a - b).abs().max())
            assert err <= 1e-4 * scale, f"{name}: {err:.3g} of {scale:.3g}"


def test_no_grad_calls_launch_once_and_build_no_graph(cuda):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as sd
    x, dt, a_log, bb, cc, d = ssd_inputs((1, 64, 2, 16, 16), torch.float32,
                                         cuda)
    q, k, v = flash_inputs((1, 64, 4, 2, 32), torch.float32, cuda)
    leaves = [t.requires_grad_() for t in (x, q)]
    for ctx in (torch.no_grad, torch.inference_mode):
        s0, f0 = sd.LAUNCHES, fa.LAUNCHES
        with ctx():
            y = sd.ssd_scan(x, dt, -torch.exp(a_log), bb, cc, d, chunk=16)
            o = fa.flash_attention(q, k, v)
        assert (sd.LAUNCHES, fa.LAUNCHES) == (s0 + 1, f0 + 1)
        assert y.grad_fn is None and o.grad_fn is None
        assert not y.requires_grad and not o.requires_grad
    assert all(t.grad is None for t in leaves)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["mamba2-130m", "h2o-danube-3-4b"])
def test_train_gradients_through_the_kernels_match_plain(cuda, arch, remat):
    """The reduced model's loss and gradients through the kernels against
    ``plain=True`` on the same card and weights (loss 1e-5 relative, each
    leaf nonzero and within 1e-3 of its largest plain gradient), with the
    kernel launched twice per layer."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as sd
    from repro_torch.models import init_params, loss_fn
    from repro_torch.tree import leaves_with_paths, tree_map
    cfg = get_config(arch).reduced()
    params = tree_map(lambda t: t.to(cuda),
                      init_params(cfg, torch.Generator().manual_seed(0)))
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in
             SyntheticTokenPipeline(cfg.vocab_size, 2, 64).batch_at(0).items()}
    mod = sd if cfg.family == "ssm" else fa
    out = {}
    for plain in (False, True):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        named = leaves_with_paths(live)
        before = mod.LAUNCHES
        loss, _ = loss_fn(cfg, live, batch, remat=remat, plain=plain)
        grads = torch.autograd.grad(loss, [t for _, t in named])
        out[plain] = (loss.item(), mod.LAUNCHES - before,
                      {n: g for (n, _), g in zip(named, grads)})
    (lk, nk, gk), (lp, np_, gp) = out[False], out[True]
    # the forward, then the backward's recompute of each layer (the
    # selective checkpoint keeps only the products, so the kernel reruns)
    assert np_ == 0 and nk == 2 * cfg.num_layers
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for name, g in gp.items():
        assert gk[name] is not None and bool(gk[name].abs().max() > 0), name
        err = float((gk[name] - g).abs().max())
        assert err <= 1e-3 * float(g.abs().max()), name


def on(tree, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device), tree)


def test_moe_prefill_on_the_card_matches_the_cpu(cuda):
    """The reduced deepseek-moe-16b's prefill through the flash kernel on
    the card against the plain path on the CPU, same weights."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.serve import serve_inputs
    from repro_torch.models import init_cache, prefill
    from repro_torch.models import layers as L
    cfg = get_config("deepseek-moe-16b").reduced()
    params, prompts = serve_inputs(cfg, batch=2, prompt_len=64, seed=1,
                                   dtype=torch.float32, device="cpu")
    runs = []
    for where in ("cpu", cuda, cuda):
        before = fa.LAUNCHES
        with L.recording(L.RoutingLog()) as log:
            logits, cache = prefill(cfg, on(params, where),
                                    init_cache(cfg, 2, 64, device=where),
                                    {"tokens": prompts.to(where)})
        assert fa.LAUNCHES - before == (0 if where == "cpu"
                                        else cfg.num_layers)
        runs.append((logits, cache, log))
    torch.cuda.synchronize()
    (lc, cc, log_c), (lk, ck, log_k), (lk2, ck2, log_k2) = runs
    assert len(log_k.calls) == cfg.num_layers - cfg.first_dense_layers
    # a deterministic combine: two card runs give the same bits
    assert torch.equal(lk, lk2)
    for seg in ck:
        for k in ("k", "v"):
            assert torch.equal(ck[seg][k], ck2[seg][k])
    card = log_k.to("cpu")
    if not L.same_routing(log_c, card):
        # a flip between the two f32 orders: the CPU path at the card's
        # routing, whose own values must put each flip at a near-tie
        with L.recording(L.RoutingLog(force=card)) as forced:
            lc, cc = prefill(cfg, params, init_cache(cfg, 2, 64),
                             {"tokens": prompts})
        assert L.routing_flips(forced, card)["worst_gap"] <= 1e-4
    torch.testing.assert_close(lk.cpu(), lc, rtol=1e-4, atol=1e-4)
    for seg in cc:
        for k in ("k", "v"):
            torch.testing.assert_close(ck[seg][k].cpu(), cc[seg][k],
                                       rtol=1e-4, atol=1e-4)


def test_hubert_train_step_on_the_card_matches_the_cpu(cuda):
    """One reduced hubert-xlarge train step (bidirectional flash kernel
    forward and recompute, plain backward) against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import init_opt_state
    from repro_torch.tree import leaves_with_paths
    cfg = get_config("hubert-xlarge").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticTokenPipeline(
        cfg.vocab_size, 2, 64, d_model=cfg.d_model, frontend=cfg.frontend,
        frontend_seq=max(cfg.frontend_seq, 0)).batch_at(0).items()}
    step = make_train_step(cfg)
    out = {}
    for where in ("cpu", cuda):
        p = on(params, where)
        before = fa.LAUNCHES
        _, opt, m = step(p, init_opt_state(p), on(batch, where))
        out[str(where)] = (opt, m, fa.LAUNCHES - before)
    (oc, mc, nc), (ok, mk, nk) = out["cpu"], out[str(cuda)]
    assert nc == 0 and nk == 2 * cfg.num_layers
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mk[key]), float(mc[key]), rtol=1e-5)
    assert not ok.mu["embed"].any()
    for (name, a), (_, b) in zip(leaves_with_paths(ok.mu),
                                 leaves_with_paths(oc.mu)):
        if name == "embed":
            continue
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-3 * float(b.abs().max()), name


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-7b"])
def test_mla_and_hybrid_prefill_kernel_matches_plain_path(cuda, arch):
    """The reduced MLA and hybrid prefills through the kernels (flash with
    V padded for MLA; SSD in every Mamba layer and flash in every
    shared-attention application for the hybrid) against the plain path
    on the same card and weights, each path with its own cache; the MoE
    routing of the MLA model under the routing contract."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as sd
    from repro_torch.launch.serve import serve_inputs
    from repro_torch.models import init_cache, prefill
    from repro_torch.models import layers as L
    cfg = get_config(arch).reduced()
    params, prompts = serve_inputs(cfg, batch=2, prompt_len=64, seed=1,
                                   dtype=torch.float32, device=cuda)
    f0, s0 = fa.LAUNCHES, sd.LAUNCHES
    with L.recording(L.RoutingLog()) as log:
        got, ck = prefill(cfg, params, init_cache(cfg, 2, 64, device=cuda),
                          {"tokens": prompts})
    if arch == "zamba2-7b":
        assert (fa.LAUNCHES - f0, sd.LAUNCHES - s0) == (2, cfg.num_layers)
    else:
        assert (fa.LAUNCHES - f0, sd.LAUNCHES - s0) == (cfg.num_layers, 0)
    with L.recording(L.RoutingLog(force=log if log.calls else None)) as fl:
        want, cp = prefill(cfg, params, init_cache(cfg, 2, 64, device=cuda),
                           {"tokens": prompts}, plain=True)
    if log.calls:
        assert L.routing_flips(fl, log)["worst_gap"] <= 1e-4
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for seg in cp:
        for name in cp[seg]:
            torch.testing.assert_close(ck[seg][name], cp[seg][name],
                                       rtol=1e-4, atol=1e-4)


def test_hybrid_loss_and_gradients_on_the_card_match_the_cpu(cuda):
    """The reduced zamba2-7b's loss and every gradient leaf (both shared
    blocks' included) through the kernels on the card against the CPU:
    loss 1e-5 relative, each leaf within 1e-3 of its largest."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as sd
    from repro_torch.models import init_params, loss_fn
    from repro_torch.tree import leaves_with_paths, tree_map
    cfg = get_config("zamba2-7b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticTokenPipeline(cfg.vocab_size, 2, 64).batch_at(0).items()}
    out = {}
    for where in ("cpu", cuda):
        live = tree_map(lambda t: t.to(where).requires_grad_(), params)
        named = leaves_with_paths(live)
        f0, s0 = fa.LAUNCHES, sd.LAUNCHES
        loss, _ = loss_fn(cfg, live, {k: v.to(where)
                                      for k, v in batch.items()})
        grads = torch.autograd.grad(loss, [t for _, t in named])
        out[str(where)] = (loss.item(), (fa.LAUNCHES - f0, sd.LAUNCHES - s0),
                           {n: g.cpu() for (n, _), g in zip(named, grads)})
    (lc, nc, gc), (lk, nk, gk) = out["cpu"], out[str(cuda)]
    # the forward and remat="full"'s recompute: two flash launches per
    # shared-attention application, two SSD launches per layer
    assert nc == (0, 0) and nk == (4, 2 * cfg.num_layers)
    assert abs(lk - lc) <= 1e-5 * abs(lc)
    for name, g in gc.items():
        assert bool(gk[name].abs().max() > 0), name
        err = float((gk[name] - g).abs().max())
        assert err <= 1e-3 * float(g.abs().max()), name
