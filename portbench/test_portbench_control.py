"""The correctness check's controls at a tiny size on the CPU: a whole run
of a cell (the look for a card skipped) is correct on the program, and
comes out not correct with each fault a cell can have planted under its
timed path; the control (the reference in TF32) fails the cell's limits."""

import time

import pytest
import torch

from portbench import control, harness

CPU = torch.device("cpu")


def run(spec, seconds):
    return harness.run(spec, seed=2 ** 31 + 7, seconds=seconds, trace=False,
                       device=CPU, started=time.perf_counter())


@pytest.mark.parametrize("cell", ["dsmoe16b.ttft", "dsv2lite16b.answer"])
def test_program_runs_correct(tiny, cell):
    out = run(tiny(cell), 1.0)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [
    ("dsmoe16b.ttft", "token_altered"),
    ("dsmoe16b.answer", "token_altered"),
    ("dsmoe16b.answer", "state_unchanged"),
    ("dsmoe16b.answer", "half_batch"),
    ("dsmoe16b.answer", "vet_altered"),
    ("dsmoe16b.answer", "vet_skipped")])
def test_fault_comes_out_not_correct(tiny, cell, fault):
    with control.fault(fault):
        out = run(tiny(cell), 0.3)
    assert not out["correct"], out["checks"]
    if fault.startswith("vet_"):
        assert out["checks"]["vet_err"]["value"] > \
            out["checks"]["vet_err"]["limit"]
    if fault == "vet_altered":  # caught by its value, the window vetted
        assert out["checks"]["vet_err"]["value"] < float("inf")


def test_a_run_whose_dashboard_vets_no_window_is_not_correct(tiny):
    spec = tiny("dsv2lite16b.answer")  # a request feeds 7 units of 512
    spec.mix["dashboard"] = dict(spec.mix["dashboard"], window=512,
                                 stride=512)
    out = run(spec, 0.3)
    assert out["attempted"] >= 1 and out["window"]["vet_windows"] == 0
    assert not out["correct"], out["checks"]
    assert out["checks"]["vet_err"]["value"] == float("inf")


@pytest.mark.parametrize("cell", ["dsmoe16b.ttft", "dsv2lite16b.answer"])
def test_control_fails_the_limits(tiny, cell):
    spec = tiny(cell)
    params, samples, _, _ = control.serve_requests(spec, 5, CPU, 4)
    got = control.model_control(spec.config, params, samples)
    limits = spec.cell["check"]["limits"]
    assert any(got[k] > limits[k] for k in got), (got, limits)
