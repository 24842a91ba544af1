"""``BENCHMARK.json`` against the rules it is written to, and every name
in it against the file that the harness finds by that name."""
from __future__ import annotations

import json
import pathlib
import re

import pytest

from gcvbench import spec

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_uniqueness():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_end_to_end_bounds():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")


def test_cells_and_their_metrics():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(CELLS) // 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for cell in CELLS:
        mine = [m for m in METRICS if cell in m.get("workloads", CELLS)]
        names = {m["name"] for m in mine}
        assert "setup_s" in names
        assert len(names & set(e2e)) >= 2
        assert names - set(e2e), cell
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_every_named_file_is_found(cell):
    loaded = spec.load_cell(cell)
    assert loaded.config["name"] == loaded.config_name
    for attr in ("make_weights", "make_requests", "make_model"):
        assert callable(getattr(loaded.model, attr))
    for attr in ("forward", "flops"):
        assert callable(getattr(loaded.reference, attr))
    assert loaded.reference.CHECK["limit"] > 0
    assert all(callable(m.reader.read) for m in loaded.metrics)


def test_layers_are_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
