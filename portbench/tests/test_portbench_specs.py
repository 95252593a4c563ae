"""``BENCHMARK.json`` and the files it names, found by name, within the
limits the benchmark's contract sets."""

import importlib.util
import re

import pytest

from portbench.core.run import PKG, cell_files
from portbench.tests.tiny import ROOT, SPEC

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_keys():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in SPEC["configs"]]
    for name in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(name), name
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    files = cell_files(SPEC, cell, ROOT)
    assert files["entry"].exists()
    assert files["config"]["name"] == files["workload"]["config"]
    assert files["limits"], "a cell compares at least one number"
    e2e = {m["name"] for m in files["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and files["per_layer"]
    for m in files["per_layer"]:
        path = PKG / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("reader", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read) and m["moves"] in e2e


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_configs_name_their_sources_and_changes(cfg):
    from portbench.core.run import load_json

    data = load_json(ROOT / cfg["file"])
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert sorted(data["changed"]) == sorted(cfg["reduced"])
    assert data["assumed"] and cfg["file"].startswith("portbench/")
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


def test_the_full_check_fits_its_time():
    n = 24  # the most cells a later benchmark may hold
    runs = 2 + 14 * n
    assert runs * (SPEC["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200


def test_four_chip_cells_are_few():
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(CELLS) // 4)
