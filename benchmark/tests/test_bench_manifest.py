"""BENCHMARK.json against the contract it is written to, and the
harness finding every piece by its name."""
from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
BENCH = harness.manifest()
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = set(e) - KEYS[section] - {"workloads"}
        assert not extra and KEYS[section] <= set(e), e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                              "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert TEXT.match(e[key]), e[key]


def test_cells_configs_and_bounds():
    configs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        c = harness.cell(w["name"])
        names = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert c["per_layer"]


def test_each_per_layer_metric_moves_what_its_cells_report():
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            reported = {e["name"] for e in harness.cell(cell)["end_to_end"]}
            assert m["moves"] in reported, (m["name"], cell)


def test_every_named_file_exists_and_loads():
    for c in BENCH["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = harness.load_json(harness.ROOT, c["file"])
        assert {"hypes", "limits", "precision", "source"} <= set(cfg)
        assert harness.reference(c["name"]).build
    for w in BENCH["workloads"]:
        c = harness.cell(w["name"])
        assert harness.mode(c["traffic_file"]["mode"]).run
    for m in BENCH["per_layer"]:
        assert callable(harness.module("metrics", m["name"]).read)


def test_files_are_named_from_name_characters():
    for root, _, files in os.walk(harness.HERE):
        if "__pycache__" in root:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), harness.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_a_full_check_fits_its_budget_with_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_a_new_cell_needs_only_new_files(monkeypatch):
    """A throwaway cell made of a new traffic file and a manifest entry
    is found by name, with nothing else edited."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "flagship.throwaway",
                               "config": "flagship", "traffic": "throwaway",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "flagship.serve" in m["workloads"]:
            m["workloads"].append("flagship.throwaway")
    traffic = dict(harness.load_json(harness.HERE, "traffic", "serve8.json"),
                   frames=3)
    real = harness.load_json

    def load(*parts):
        if parts[-1] == "throwaway.json":
            return traffic
        return real(*parts)

    monkeypatch.setattr(harness, "load_json", load)
    c = harness.cell("flagship.throwaway", bench)
    assert c["traffic_file"]["frames"] == 3
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s",
                                                   "serve_frames_per_s"}
    assert {m["name"] for m in c["per_layer"]} == {
        m["name"] for m in BENCH["per_layer"]
        if "flagship.serve" in m["workloads"]}
