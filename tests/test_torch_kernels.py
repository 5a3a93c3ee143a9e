"""The port's kernel packages on the CPU: each wrapper's plain version
against the reference's Pallas kernel run in interpret mode.

A wrapper given CPU tensors runs its plain PyTorch version (the port's
analogue of interpret mode) and counts no launch; the CUDA kernels
themselves are held to the same plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.  Tolerances as in
``torch_port_contract``.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.changepoint import estimate_changepoint as ref_estimate
from repro.core.changepoint import two_segment_sse as ref_sse
from repro.kernels.changepoint.ops import (auto_block, changepoint_pallas,
                                           two_segment_sse_pallas)
from repro.kernels.windowvet.ops import fused_window_vet as ref_fused
from repro.kernels.windowvet.ops import staged_bytes as ref_staged_bytes
from repro.kernels.windowvet.ref import ref_window_vet as ref_scalar
import repro_torch.core.changepoint as port_cp
from repro_torch.core.changepoint import estimate_changepoint as port_estimate
from repro_torch.core.changepoint import (two_segment_sse, xla_order_cumsum,
                                          xla_order_log)
from repro_torch.kernels import runtime
from repro_torch.kernels.changepoint import ops as cp
from repro_torch.kernels.changepoint import changepoint_ref
from repro_torch.kernels.windowvet import ops as wv
from repro_torch.kernels.windowvet import ref_window_vet
from repro_torch.profiling import simulate_records

from torch_port_contract import assert_contract, curve, cut_gap, sim_matrix


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
def ragged_entry(groups, omega=3, landscape=False):
    """The ragged entry on CPU tensors over ``groups`` packed end to end."""
    (values, starts, lengths), span = cp.pack_rows(groups, "cpu")
    return cp.changepoint_ragged(values, starts, lengths, omega,
                                 landscape=landscape, span=span)


def simulated_log_rows(lengths, seed):
    return [np.log(np.sort(simulate_records(int(n), seed=seed + i).times))
            .astype(np.float32) for i, n in enumerate(lengths)]


class TestChangepointPlain:
    @pytest.mark.parametrize("n", [6, 64, 200, 1000])
    def test_landscape_and_cut_match_pallas_interpret(self, n):
        z = log_curves(8, n, seed=n)
        t, sse = ragged_entry([z], landscape=True)
        sse = sse.reshape(8, n)
        assert t.shape == (8,) and t.dtype == torch.int32
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
        """On CPU tensors the entry is the plain twin, and the twin is the
        prefix-sum decomposition bit for bit."""
        z = log_curves(5, 300, seed=1)
        before = cp.LAUNCHES
        t, sse = ragged_entry([z], landscape=True)
        want_sse, want_t = cp.sse_scan_plain(
            *cp.prefix_inputs(torch.from_numpy(z)))
        torch.testing.assert_close(sse.reshape(5, 300), want_sse, rtol=0,
                                   atol=0)
        torch.testing.assert_close(t, want_t, rtol=0, atol=0)
        assert cp.LAUNCHES == before  # the plain path launches nothing

    def test_changepoint_cuda_equals_core_on_cpu(self):
        z = torch.from_numpy(log_curves(5, 128, seed=2))
        torch.testing.assert_close(cp.changepoint_cuda(z), changepoint_ref(z),
                                   rtol=0, atol=0)
        assert cp.changepoint_cuda(z[0]).shape == ()
        torch.testing.assert_close(cp.two_segment_sse_cuda(z),
                                   two_segment_sse(z), rtol=0, atol=0)

    def test_all_inf_row_gives_t1_and_ties_take_the_lowest_index(self):
        n = 8
        z = np.zeros((2, n), np.float32)  # flat rows: every valid k ties
        t, _ = ragged_entry([z], omega=3)
        assert t.tolist() == [3, 3]  # first valid candidate wins the tie
        # n < 2*omega: the entry refuses, the plain twin's landscape is
        # all +inf and its cut 1, as the kernel's.
        (values, starts, lengths), _ = cp.pack_rows([z], "cpu")
        t, sse = cp.changepoint_ragged_plain(values, starts, lengths, omega=5,
                                             landscape=True)
        assert torch.isinf(sse).all() and t.tolist() == [1, 1]
        sse, t = cp.sse_scan_plain(*cp.prefix_inputs(torch.from_numpy(z)),
                                   omega=5)
        assert torch.isinf(sse).all() and t.tolist() == [1, 1]

    @pytest.mark.parametrize("n,omega", [(1, 3), (5, 3), (7, 4)])
    def test_short_input_raises_like_the_reference(self, n, omega):
        y = np.linspace(1.0, 2.0, n).astype(np.float32)
        with pytest.raises(ValueError, match="2\\*omega"):
            changepoint_pallas(y, omega=omega, interpret=True)
        with pytest.raises(ValueError, match="2\\*omega"):
            cp.changepoint_cuda(torch.from_numpy(y), omega=omega)
        long_row = np.linspace(1.0, 2.0, 4 * omega).astype(np.float32)
        with pytest.raises(ValueError, match="2\\*omega"):
            ragged_entry([long_row[None], y[None]], omega=omega)

    def test_wrong_device_raises_instead_of_falling_back(self):
        values = torch.zeros(32, device="meta")
        meta = torch.zeros(2, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="cpu or cuda"):
            cp.changepoint_ragged(values, meta, meta, span=(16, 16))
        with pytest.raises(ValueError, match="cpu or cuda"):
            cp.changepoint_cuda(values.reshape(2, 16))

    def test_ragged_plain_twin_cuts_equal_every_per_row_estimator(self):
        """Mixed lengths in one arena: the plain twin's cut on every row
        equals the port's per-row ``estimate_changepoint`` and the
        reference's; on a few rows also its Pallas kernel (interpret)."""
        rng = np.random.default_rng(15)
        lengths = np.concatenate([rng.integers(6, 65, 40), [1000] * 3,
                                  [8192] * 2])
        rng.shuffle(lengths)
        rows = simulated_log_rows(lengths, seed=300)
        arena = np.concatenate(rows)
        starts = np.cumsum(lengths) - lengths
        t, _ = cp.changepoint_ragged_plain(torch.from_numpy(arena),
                                           torch.from_numpy(starts),
                                           torch.from_numpy(lengths))
        for i, row in enumerate(rows):
            got = int(t[i])
            assert got == int(port_estimate(torch.from_numpy(row)))
            assert got == int(ref_estimate(jnp.asarray(row)))
        for i in (0, int(np.argmax(lengths == 1000)),
                  int(np.argmax(lengths == 8192))):
            row = rows[i]
            assert int(t[i]) == int(changepoint_pallas(
                jnp.asarray(row), block=auto_block(row.size), interpret=True))

    def test_ragged_rows_may_sit_anywhere_in_the_arena(self):
        """Gaps and overlapping windows: each row's cut and landscape are
        those of the row alone."""
        arena = torch.from_numpy(simulated_log_rows([400], seed=9)[0])
        starts = torch.tensor([0, 5, 300, 120], dtype=torch.int32)
        lengths = torch.tensor([40, 64, 100, 7], dtype=torch.int32)
        t, _ = cp.changepoint_ragged(arena, starts, lengths, span=(7, 100))
        for r in range(4):
            row = arena[starts[r]:starts[r] + lengths[r]]
            assert int(t[r]) == int(changepoint_ref(row))

    def test_scan_layout_mirrors_the_kernel_source(self):
        """The wrapper sizes the kernel's scans (shared memory or global
        scratch) from the ``.cu``'s constants."""
        src = "".join((runtime.CSRC / f).read_text()
                      for f in ("common.cuh", "changepoint.cu"))
        consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
        assert consts["kScanBlock"] == str(cp._SCAN_BLOCK)
        assert consts["kScanPad"] == "kScanBlock + 1" and \
            cp._SCAN_PAD == cp._SCAN_BLOCK + 1
        assert eval(consts["kSharedFloats"].replace("/", "//")) == \
            cp.SHARED_FLOATS
        # about 12.8 bytes per element; 8192 in shared memory, 65,536 not
        assert cp.scan_floats(16) == 3 * 17
        assert cp.scan_floats(1000) == 3 * 17 * (63 + 4 + 1)
        assert cp.scan_floats(8192) <= cp.SHARED_FLOATS < cp.scan_floats(65536)


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

    @pytest.mark.parametrize("log_space", [True, False], ids=["log", "raw"])
    def test_plain_log_and_scans_are_xla_order(self, log_space):
        """The plain version's log and prefix sums are ``xla_order_log`` and
        ``xla_order_cumsum`` of each row alone, bit for bit, and so
        ``jnp.log`` and ``jnp.cumsum`` (the reference kernel's in interpret
        mode), on every valid position of a launch padded to 4096."""
        arena, starts, lengths = ragged([2, 7, 64, 100, 192, 700, 4000],
                                        seed=8)
        tensors, lmax, _, _ = wv.launch_inputs(arena, starts, lengths,
                                               torch.device("cpu"))
        mask, y, z, cy, cyy, cxy = wv.sorted_scans(
            *tensors[:3], lmax=lmax, log_space=log_space)
        assert lmax == 4096
        for r, n in enumerate(lengths):
            row = y[r, :n]
            assert mask[r].sum() == n and torch.isinf(y[r, n:]).all()
            want_z = xla_order_log(torch.clamp(row, min=1e-12)) \
                if log_space else row
            assert torch.equal(z[r, :n], want_z)
            zm = want_z - want_z[(n - 1) // 2]
            chans = (zm, zm * zm, torch.arange(1, n + 1) * zm)
            for got, want in zip((cy, cyy, cxy), chans):
                assert torch.equal(got[r, :n], xla_order_cumsum(want))
                np.testing.assert_array_equal(
                    got[r, :n].numpy(), np.asarray(jnp.cumsum(want.numpy())))
            if log_space:
                np.testing.assert_array_equal(
                    z[r, :n].numpy(),
                    np.asarray(jnp.log(jnp.maximum(row.numpy(), 1e-12))))

    @pytest.mark.parametrize("log_space", [True, False], ids=["log", "raw"])
    def test_rows_vet_the_same_alone_and_padded_to_max_lmax(self, log_space):
        """Padding invariance: every lane of a row is bitwise the same when
        the row is vetted alone (lmax = pow2(n)) and in a launch padded to
        ``MAX_LMAX`` (the kernel's block path on the card)."""
        rng = np.random.default_rng(11)
        lengths = np.concatenate([np.arange(2, 40), [63, 64, 65, 127, 128],
                                  rng.integers(129, wv.MAX_LMAX, 24)])
        arena = sim_matrix(1, 3 * wv.MAX_LMAX, seed=12)[0]
        starts = rng.integers(0, arena.size - wv.MAX_LMAX, lengths.size)
        cpu = torch.device("cpu")
        tensors, lmax, _, _ = wv.launch_inputs(
            arena, np.r_[starts, 0], np.r_[lengths, wv.MAX_LMAX], cpu)
        padded = wv.fused_window_vet_plain(*tensors, lmax=lmax,
                                           log_space=log_space)
        assert lmax == wv.MAX_LMAX and wv.kernel_path(lmax) == "block"
        for r, (s, n) in enumerate(zip(starts, lengths)):
            one, lmax1, _, _ = wv.launch_inputs(arena, [s], [n], cpu)
            alone = wv.fused_window_vet_plain(*one, lmax=lmax1,
                                              log_space=log_space)[0]
            assert lmax1 == max(8, wv._pow2(n))
            assert torch.equal(alone, padded[r]), (n, alone, padded[r])

    def test_cuts_against_pallas_interpret_on_ragged_sets(self):
        """The plain version against the reference's Pallas kernel in
        interpret mode over 972 rows: 6 seeds x {64/128/192 tiled, 8..1100
        step 37, 300/900/2000/4000}.  Both take jnp.log's and jnp.cumsum's
        values, but the reference's fused graph rounds its segment SSE its
        own way, so near-ties still flip: 36 rows here (44 with the block
        scan and logf this version replaced), and the count may only fall.

        Rows of up to 256 records (the fused path's windows at the default
        ``buckets=64``) hold the whole near-tie contract.  On longer rows
        the reference disagrees with itself by more than its 1e-4 gap: its
        fused kernel's cut and the argmin of its own landscape
        (``two_segment_sse`` on the same curve, under ``jit``) lie up to
        ``spread`` apart on that landscape.  A port flip there may be no
        wider than that."""
        sets = (np.tile([64, 128, 192], 43)[:128], np.arange(8, 1101, 37),
                np.array([300, 900, 2000, 4000]))
        names = ("vet", "ei", "oc", "pr", "t")
        landscape = jax.jit(ref_sse)
        flips, spread, gaps, rows = 0, 0.0, [], 0
        for seed in range(6):
            for lengths in sets:
                arena, starts, lengths = ragged(lengths, seed=seed)
                got = wv.fused_window_vet(arena, starts, lengths,
                                          device="cpu")
                ref = ref_fused(arena, starts, lengths, interpret=True)
                times_of = lambda i: arena[starts[i]:starts[i] + lengths[i]]
                short = lengths <= 256
                flips += assert_contract(
                    {k: v[short] for k, v in zip(names, got)},
                    {k: v[short] for k, v in zip(names, ref)},
                    lambda i: times_of(np.flatnonzero(short)[i]),
                    context=f"windowvet seed {seed}")
                for i in np.flatnonzero(~short):
                    sse = np.asarray(landscape(jnp.asarray(
                        curve(times_of(i))[0])), np.float64)
                    gap = lambda a, b: abs(sse[a - 1] - sse[b - 1]) / sse[b - 1]
                    t_est = int(np.argmin(sse)) + 1
                    spread = max(spread, gap(ref[4][i], t_est))
                    if got[4][i] != ref[4][i]:
                        flips += 1
                        gaps.append(gap(got[4][i], ref[4][i]))
                same = got[4] == ref[4]
                for k in range(4):
                    np.testing.assert_allclose(got[k][same], ref[k][same],
                                               rtol=1e-5)
                rows += lengths.size
        assert rows == 972 and flips <= 36, flips
        assert max(gaps) <= spread, (max(gaps), spread)

    def test_kernel_constants_mirror_the_source(self):
        """``windowvet.cu`` and ``common.cuh`` hold the wrapper's limits, the
        scan's block of 16 (``xla_order_cumsum``'s) and the log's f32
        constants (``xla_order_log``'s)."""
        src = "".join((runtime.CSRC / f).read_text()
                      for f in ("common.cuh", "windowvet.cu"))
        ints = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
        floats = {k: float.fromhex(v) for k, v in re.findall(
            r"constexpr float (k\w+) = (-?0x[0-9a-f.]+p-?\d+)f;", src)}
        assert int(ints["kWarpMaxLmax"]) == wv.WARP_MAX_LMAX
        assert int(ints["kMaxLmax"]) == wv.MAX_LMAX
        assert int(ints["kScanBlock"]) == port_cp._BLOCK
        assert wv.kernel_path(wv.WARP_MAX_LMAX) == "warp"
        assert wv.kernel_path(2 * wv.WARP_MAX_LMAX) == "block"
        f32 = lambda v: float(np.float32(v))
        want = {f"kLogP{i}": f32(c) for i, c in enumerate(port_cp._LOG_P)}
        want.update(kLogQ1=f32(port_cp._LOG_Q1), kLogQ2=f32(port_cp._LOG_Q2),
                    kSqrtHalf=f32(port_cp._SQRTHF), kTiny=f32(wv._TINY))
        assert floats == want

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
