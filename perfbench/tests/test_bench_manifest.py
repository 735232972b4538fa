"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

import json
import re

import pytest

from harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.load_benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_text():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                        and "\t" not in e[key], (e["name"], key)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                               "device_trace")


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        cell = manifest.find_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        assert set(cell.limits), w["name"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metric_has_a_reader(metric):
    read = manifest.metric_reader(metric)
    assert read({}) is None       # nothing to read: no number, never 0


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        manifest.find_cell("no-such-cell")


def test_check_budget_fits_with_24_cells():
    per_cell = 14 * (BENCH["run_seconds"] + 60) + 2 * 90
    assert 2 * (BENCH["run_seconds"] + 60) + 24 * per_cell + 1200 <= 43200
