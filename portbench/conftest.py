"""Fixtures of portbench's CPU tests: cells at a tiny size (their family's
``TINY``) that the harness runs on the CPU, where the port takes its
kernels' plain versions."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT / "src") not in sys.path:  # the port, as run.py finds it
    sys.path.insert(0, str(ROOT / "src"))

from portbench import families, harness  # noqa: E402


def tiny_config(name: str) -> dict:
    """Configuration ``name`` at its family's CPU test size (``TINY``)."""
    c = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                   .read_text())
    return families.of(c).TINY(c)


def tiny_spec(cell: str) -> harness.Spec:
    """Cell ``cell`` of BENCHMARK.json at the tiny size: its traffic with
    short prompts, its limits and metrics unchanged."""
    spec = harness.load_spec(cell, ROOT)
    spec.config = tiny_config(spec.cell["config"])
    spec.mix = dict(spec.mix, prompt_lengths=(
        [16, 32, 48, 64] if spec.mix["batch"] == 1 else [32]))
    if spec.mix["dashboard"]:  # a unit a record, windows of 7 units: the
        # first request's 7 decode records make a window due
        spec.mix["dashboard"] = dict(spec.mix["dashboard"], record_unit=1,
                                     window=7, stride=7)
    return spec


@pytest.fixture
def tiny():
    return tiny_spec


@pytest.fixture(autouse=True)
def one_thread():
    """These tests' CPU work in one thread, so the suite's other workers
    keep their cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
