"""Each per-layer metric's reader on a synthetic record of one traced
window."""

import importlib.util
from pathlib import Path

import pytest

from portbench import yardstick as Y

HERE = Path(__file__).resolve().parent
C = {"hidden_size": 2048, "num_attention_heads": 16,
     "num_key_value_heads": 16, "intermediate_size": 10944,
     "moe_intermediate_size": 1408, "n_routed_experts": 64,
     "num_experts_per_tok": 6, "n_shared_experts": 2,
     "first_k_dense_replace": 1, "num_hidden_layers": 28,
     "vocab_size": 102400,
     "runs": {"family": "deepseek_moe"}}
MS = 1_000_000  # ns


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "r", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def records():
    """Two requests: a 1 x 1024 prefill (0-100 ms) and one decode step
    (100-120 ms), a dashboard tick (120-121 ms); then a 1 x 2048 prefill
    (130-330 ms).  Kernels: flash 10 ms, gemm 60 ms, other 10 ms in the
    first prefill; 3 kernels in the decode step; flash 20, gemm 150 in
    the second."""
    spans = [("request", 0, 121 * MS, {"batch": 1, "prompt": 1024}),
             ("prefill", 0, 100 * MS, {"batch": 1, "prompt": 1024}),
             ("decode", 100 * MS, 120 * MS, {"batch": 1, "pos": 1024}),
             ("dashboard", 120 * MS, 121 * MS, {}),
             ("request", 130 * MS, 330 * MS, {"batch": 1, "prompt": 2048}),
             ("prefill", 130 * MS, 330 * MS, {"batch": 1, "prompt": 2048})]
    kernels = [("flash_wgmma_tf32", 1 * MS, 11 * MS),
               ("sm80_xmma_gemm_f32", 11 * MS, 71 * MS),
               ("elementwise", 71 * MS, 81 * MS),
               ("gemv", 101 * MS, 102 * MS), ("add", 102 * MS, 103 * MS),
               ("argmax", 103 * MS, 104 * MS),
               ("flash_wgmma_tf32", 131 * MS, 151 * MS),
               ("cutlass_80_simt_sgemm", 151 * MS, 301 * MS)]
    busy = sum(e - s for _, s, e in kernels)
    trace = {"kernels": kernels, "spans": spans, "window_ns": (0, 330 * MS),
             "busy_ns": busy, "busy_s": busy / 1e9, "window_s": 0.33}
    host = [(n, s / 1e9, e / 1e9, a) for n, s, e, a in spans]
    return {"config": C, "spans": host, "trace": trace,
            "counters": {"moe_routed": 400, "moe_dropped": 100}}


def test_flash_roofline_pct():
    bound = Y.flash_bound_s(C, 1, 1024) + Y.flash_bound_s(C, 1, 2048)
    assert reader("flash_roofline_pct")(records()) == pytest.approx(
        100 * bound / 0.030)


def test_mfu_pct():
    ops = Y.prefill_flops(C, 1, 1024) + Y.prefill_flops(C, 1, 2048)
    assert reader("mfu_pct")(records()) == pytest.approx(
        100 * ops / (0.300 * Y.F32_PEAK_OPS))


def test_gemm_ms_per_ktok():
    assert reader("gemm_ms_per_ktok")(records()) == pytest.approx(
        (60 + 150) / 3.072)


def test_moe_dropped_pct():
    assert reader("moe_dropped_pct")(records()) == pytest.approx(25.0)


@pytest.mark.parametrize("name", ["idle_pct.ttft", "idle_pct.answer"])
def test_idle_pct(name):
    busy = 0.010 + 0.060 + 0.010 + 0.003 + 0.020 + 0.150
    assert reader(name)(records()) == pytest.approx(
        100 * (1 - busy / 0.33))


def test_decode_and_dashboard_host_times():
    assert reader("decode_ms_per_step")(records()) == pytest.approx(20.0)
    assert reader("vet_tick_ms")(records()) == pytest.approx(1.0)


def test_kernels_per_decode_step():
    assert reader("kernels_per_decode_step")(records()) == 3


@pytest.mark.parametrize("name", [
    "flash_roofline_pct", "mfu_pct", "gemm_ms_per_ktok", "moe_dropped_pct",
    "idle_pct.ttft", "decode_ms_per_step", "kernels_per_decode_step",
    "vet_tick_ms"])
def test_nothing_to_read_gives_nothing(name):
    empty = {"config": C, "spans": [], "counters": {},
             "trace": {"kernels": [], "spans": [], "window_ns": (0, 0),
                       "busy_ns": 0, "busy_s": 0.0, "window_s": 0.0}}
    assert reader(name)(empty) is None
