"""The port's examples (``examples/port_*.py``) run end to end on the CPU
at their smallest arguments, each through its ``main(argv)``, with
``--device cpu`` (the card is their default)."""

import importlib.util
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _main(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.mark.parametrize("stanza", ["6", "8"])
def test_port_quickstart(stanza):
    got = _main("port_quickstart")(["--stanza", stanza, "--device", "cpu"])
    if stanza == "6":
        assert got["streams"] == 12 and got["vet_job"] >= 1.0
    else:
        assert got["agree"] and got["converged"]


def test_port_serve_decode():
    got = _main("port_serve_decode")(["--reduced", "--batch", "2",
                                      "--prompt-len", "8", "--gen-len",
                                      "16", "--device", "cpu"])
    assert got["tokens"] == [2, 16]


def test_port_train_100m(tmp_path):
    got = _main("port_train_100m")(["--reduced", "--steps", "3", "--batch",
                                    "2", "--seq-len", "16", "--device",
                                    "cpu", "--ckpt-dir", str(tmp_path)])
    assert got["steps"] == 3 and got["loss_first"] > 0
    assert any(tmp_path.iterdir())  # a checkpoint was written


def test_port_vet_tuning():
    got = _main("port_vet_tuning")(["--steps", "5", "--records", "200",
                                    "--workers", "1", "--device", "cpu"])
    assert got["best_vet"] > 0
    assert set(got["targets"]) == {1}
