"""BENCHMARK.json and the files it names: every cell, configuration, mix
and metric reader loads by name, and the names and units keep to the
benchmark's character rules."""

import importlib.util
import json
import re
from pathlib import Path

import pytest

from portbench import families, harness

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    spec = harness.load_spec(cell, ROOT)
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    own = json.loads((ROOT / "portbench" / "workloads" / f"{cell}.json")
                     .read_text())
    assert set(own) == {"trace_requests", "check"}  # the rest: BENCHMARK.json
    assert spec.cell == dict(entry, **own) and entry["chips"] == 1
    assert "clients" not in spec.mix
    assert {"setup_s"} < {m["name"] for m in spec.end_to_end}
    assert spec.per_layer
    assert set(spec.cell["check"]["limits"]) >= set(
        families.of(spec.config).NUMBERS)


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


def test_configs_name_their_files_and_cuts():
    for c in BENCH["configs"]:
        f = ROOT / c["file"]
        assert f.parts[len(ROOT.parts)] == "portbench"
        data = json.loads(f.read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert not [k for k in c["reduced"]
                    if k.endswith(("_dim", "_rank", "_size"))]


def test_every_metric_moves_what_its_cells_report():
    for m in BENCH["per_layer"]:
        moved = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in moved.get("workloads", CELLS)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    path = ROOT / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)
