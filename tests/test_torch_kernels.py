"""The port's kernel packages on the CPU: each wrapper's plain version
against the reference's Pallas kernel run in interpret mode.

A wrapper given CPU tensors runs its plain PyTorch version (the port's
analogue of interpret mode) and counts no launch; the CUDA kernels
themselves are held to the same plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.  Tolerances as in
``torch_port_contract``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.changepoint.ops import (auto_block, changepoint_pallas,
                                           two_segment_sse_pallas)
from repro.kernels.windowvet.ops import fused_window_vet as ref_fused
from repro.kernels.windowvet.ops import staged_bytes as ref_staged_bytes
from repro.kernels.windowvet.ref import ref_window_vet as ref_scalar
from repro_torch.kernels.changepoint import ops as cp
from repro_torch.kernels.changepoint import changepoint_ref
from repro_torch.kernels.windowvet import ops as wv
from repro_torch.kernels.windowvet import ref_window_vet

from torch_port_contract import assert_contract, cut_gap, sim_matrix


def log_curves(rows, n, seed):
    return np.log(np.sort(sim_matrix(rows, n, seed), axis=1)).astype(np.float32)


def ragged(lengths, seed=0):
    """A shared arena plus overlapping ragged windows inside it."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths)
    arena = sim_matrix(1, int(lengths.max()) * 3, seed)[0]
    starts = rng.integers(0, arena.size - lengths + 1)
    return arena, starts, lengths


# ------------------------------------------------------------ changepoint
class TestChangepointPlain:
    @pytest.mark.parametrize("n", [6, 64, 200, 1000])
    def test_landscape_and_cut_match_pallas_interpret(self, n):
        z = log_curves(8, n, seed=n)
        sse, t = cp.sse_scan(*cp.prefix_inputs(torch.from_numpy(z)))
        assert sse.shape == (8, n) and t.shape == (8,) and t.dtype == torch.int32
        for i, row in enumerate(z):
            want = np.asarray(two_segment_sse_pallas(
                jnp.asarray(row), block=auto_block(n), interpret=True))
            fin = np.isfinite(want)
            np.testing.assert_array_equal(fin, np.isfinite(sse[i].numpy()))
            # f32 prefix sums round differently (see torch_port_contract).
            assert np.abs(sse[i].numpy()[fin] - want[fin]).max() <= \
                1e-3 * np.abs(want[fin]).max()
            t_ref = int(changepoint_pallas(jnp.asarray(row), block=auto_block(n),
                                           interpret=True))
            if int(t[i]) != t_ref:
                assert cut_gap(row, int(t[i]), t_ref) <= 1e-4

    def test_wrapper_is_the_plain_version_on_cpu(self):
        z = torch.from_numpy(log_curves(5, 300, seed=1))
        before = cp.LAUNCHES
        got = cp.sse_scan(*cp.prefix_inputs(z))
        want = cp.sse_scan_plain(*cp.prefix_inputs(z))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert cp.LAUNCHES == before  # the plain path launches nothing

    def test_changepoint_cuda_equals_core_on_cpu(self):
        z = torch.from_numpy(log_curves(5, 128, seed=2))
        torch.testing.assert_close(cp.changepoint_cuda(z), changepoint_ref(z),
                                   rtol=0, atol=0)
        assert cp.changepoint_cuda(z[0]).shape == ()

    def test_all_inf_row_gives_t1_and_ties_take_the_lowest_index(self):
        n = 8
        z = torch.zeros(2, n)  # flat rows: every valid k ties
        sse, t = cp.sse_scan(*cp.prefix_inputs(z), omega=3)
        assert t.tolist() == [3, 3]  # first valid candidate wins the tie
        sse, t = cp.sse_scan(*cp.prefix_inputs(z), omega=5)  # n < 2*omega
        assert torch.isinf(sse).all() and t.tolist() == [1, 1]

    @pytest.mark.parametrize("n,omega", [(1, 3), (5, 3), (7, 4)])
    def test_short_input_raises_like_the_reference(self, n, omega):
        y = np.linspace(1.0, 2.0, n).astype(np.float32)
        with pytest.raises(ValueError, match="2\\*omega"):
            changepoint_pallas(y, omega=omega, interpret=True)
        with pytest.raises(ValueError, match="2\\*omega"):
            cp.changepoint_cuda(torch.from_numpy(y), omega=omega)

    def test_wrong_device_raises_instead_of_falling_back(self):
        z = torch.zeros(2, 16, device="meta")
        ops_in = (z, z, z, torch.zeros(2, 3, device="meta"),
                  tuple(torch.zeros(16, device="meta") for _ in range(4)))
        with pytest.raises(ValueError, match="cpu or cuda"):
            cp.sse_scan(*ops_in)


# -------------------------------------------------------------- windowvet
class TestWindowvetPlain:
    @pytest.mark.parametrize("cut_space", ["log", "raw"])
    def test_ragged_rows_match_pallas_interpret_and_scalar_loop(self, cut_space):
        arena, starts, lengths = ragged(np.tile([64, 128, 192, 37, 256], 6),
                                        seed=4)
        got = wv.fused_window_vet(arena, starts, lengths, cut_space=cut_space,
                                  device="cpu")
        pallas = ref_fused(arena, starts, lengths, cut_space=cut_space,
                           interpret=True)
        scalar = ref_scalar(arena, starts, lengths, cut_space=cut_space)
        names = ("vet", "ei", "oc", "pr", "t")
        window = lambda i: arena[starts[i]:starts[i] + lengths[i]]
        for ref in (pallas, scalar):
            assert_contract(dict(zip(names, got)), dict(zip(names, ref)),
                            window, None, cut_space, f"windowvet {cut_space}")
        np.testing.assert_array_equal(got[5], lengths)

    def test_degenerate_rows_match_both_rungs(self):
        """n < 2*omega: an all-inf landscape gives t = 1, as jnp.argmin."""
        arena, starts, lengths = ragged(np.tile([2, 3, 4, 5, 6, 7], 3), seed=5)
        got = wv.fused_window_vet(arena, starts, lengths, device="cpu")
        pallas = ref_fused(arena, starts, lengths, interpret=True)
        for a, b in zip(got[:4], pallas[:4]):
            np.testing.assert_allclose(a, b, rtol=1e-5)
        np.testing.assert_array_equal(got[4], pallas[4])
        assert (got[4][lengths < 6] == 1).all()

    def test_port_scalar_loop_matches_the_fused_plain_version(self):
        arena, starts, lengths = ragged([100, 50, 256, 9], seed=6)
        got = wv.fused_window_vet(arena, starts, lengths, device="cpu")
        loop = ref_window_vet(arena, starts, lengths)
        assert_contract(dict(zip(("vet", "ei", "oc", "pr", "t"), got)),
                        dict(zip(("vet", "ei", "oc", "pr", "t"), loop)),
                        lambda i: arena[starts[i]:starts[i] + lengths[i]],
                        context="port loop")

    def test_row_padding_and_plain_dispatch(self):
        """Rows pad to a power of two >= 8 by repeating the last row; a CPU
        launch runs the plain version and counts no launch."""
        arena, starts, lengths = ragged([64, 80, 96], seed=7)
        before = wv.LAUNCHES
        tensors, lmax, pr64, _ = wv.launch_inputs(arena, starts, lengths,
                                                  torch.device("cpu"))
        assert tensors[1].shape == (8,) and lmax == 128
        assert tensors[0].shape[0] == 512  # pow2(288 + lmax)
        assert (tensors[1][3:] == tensors[1][2]).all()
        out = wv.fused_window_vet_scan(*tensors, lmax=lmax)
        torch.testing.assert_close(out, wv.fused_window_vet_plain(*tensors,
                                                                  lmax=lmax),
                                   rtol=0, atol=0)
        assert out.shape == (8, wv.LANES) and wv.LAUNCHES == before

    @pytest.mark.parametrize("rows,max_len,alen", [(1, 2, 10), (3, 64, 500),
                                                   (9, 200, 1000),
                                                   (100, 4000, 10 ** 5)])
    def test_staged_bytes_is_the_reference_formula(self, rows, max_len, alen):
        assert wv.staged_bytes(alen, rows, max_len) == ref_staged_bytes(
            alen, rows, max_len)

    @pytest.mark.parametrize("starts,lengths,match", [
        ([], [], "at least one window"),
        ([0, 1], [4], "disagree"),
        ([0], [1], ">= 2 records"),
        ([95], [10], "out of arena bounds"),
        ([-1], [4], "out of arena bounds"),
    ])
    def test_input_errors_match_the_reference(self, starts, lengths, match):
        arena = np.linspace(1e-3, 2e-3, 100)
        with pytest.raises(ValueError, match=match):
            ref_fused(arena, starts, lengths, interpret=True)
        with pytest.raises(ValueError, match=match):
            wv.fused_window_vet(arena, starts, lengths, device="cpu")

    def test_windows_past_the_kernel_limit_are_refused(self):
        arena = np.linspace(1e-3, 2e-3, wv.MAX_LMAX + 10)
        with pytest.raises(ValueError, match="do not fit"):
            wv.fused_window_vet(arena, [0], [wv.MAX_LMAX + 1], device="cpu")

    def test_wrong_device_raises_instead_of_falling_back(self):
        t = torch.zeros(8, device="meta")
        with pytest.raises(ValueError, match="cpu or cuda"):
            wv.fused_window_vet_scan(torch.zeros(64, device="meta"),
                                     t.int(), t.int(), t, lmax=8)


def test_every_entry_point_has_its_ctypes_signature():
    """Each ``extern "C"`` entry of ``csrc/*.cu`` is registered in
    ``runtime._SIGNATURES`` with one ctypes type per C parameter (a pointer
    or the stream as c_void_p, an int as c_int, a float as c_float): a
    mismatch would pass wrong arguments on the card without an error."""
    import ctypes
    import re
    from repro_torch.kernels import runtime

    def ctype(param):
        if "*" in param or "cudaStream_t" in param:
            return ctypes.c_void_p
        return ctypes.c_float if param.split()[0] == "float" else ctypes.c_int

    found = {}
    for src in runtime.CSRC.glob("*.cu"):
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)',
                             src.read_text()):
            found[m.group(1)] = [ctype(p.strip()) for p in
                                 m.group(2).split(",")]
    assert set(found) >= {"ssd_scan_f32", "flash_attention_f32",
                          "flash_attention_bf16"}
    assert runtime._SIGNATURES == found
