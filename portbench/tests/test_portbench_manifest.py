"""BENCHMARK.json against the benchmark's contract, and every file it names
in place."""
from __future__ import annotations

import json
import os
import re

import pytest

from portbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_names_and_units(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entry_keys(bench, section, keys):
    for entry in bench[section]:
        extra = set(entry) - keys - {"workloads"}
        assert not extra and keys <= set(entry), (entry, extra)


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def reports(bench, metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if reports(bench, m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(reports(bench, m, w["name"]) for m in bench["per_layer"])


def test_per_layer_cells_report_what_they_move(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert reports(bench, moved, cell), (m["name"], cell)


def test_one_layer_name_per_layer(bench):
    for m in bench["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


def test_files_in_place(bench):
    for c in bench["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith("portbench/") and os.path.exists(path)
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"]
    for w in bench["workloads"]:
        with open(os.path.join(ROOT, "portbench", "workloads",
                               w["name"] + ".json")) as f:
            wl = json.load(f)
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "traffic", wl["traffic"] + ".py"))
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert wl["limits"], w["name"]
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))


def test_check_budget_fits(bench):
    """A full check of 24 cells at run_seconds fits in 43200 s."""
    cells = 24
    total = (2 + 14 * cells) * (bench["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200
    assert total <= 43200
