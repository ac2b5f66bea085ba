"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
resolving to its files."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.core import manifest as mf

MAN = mf.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]
CELLS = MAN["workloads"]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_and_units():
    for group in (MAN["configs"], CELLS, METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in CELLS:
        assert NAME.match(c["traffic"]) and NAME.match(c["config"])
        assert _line(c["why"]) and c["chips"] in (1, 4)
    for c in MAN["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for c in CELLS:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])


@pytest.mark.parametrize("cell", [c["name"] for c in CELLS])
def test_cell_resolves(cell):
    entry = next(c for c in CELLS if c["name"] == cell)
    wl = mf.workload(cell)
    assert wl["config"] == entry["config"]
    assert wl["traffic"] == entry["traffic"]
    assert wl.get("chips", 1) == entry["chips"]
    drv = mf.driver(wl["driver"])
    for fn in ("setup", "window", "release", "check", "control"):
        assert callable(getattr(drv, fn))
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())
    cfg = next(c for c in MAN["configs"] if c["name"] == entry["config"])
    assert cfg["file"] == f"benchmark/configs/{entry['config']}.json"
    assert mf.config(entry["config"])["name"] == entry["config"]
    # every cell reports set-up, another end-to-end metric and a per-layer
    e2e = [m["name"] for m in mf.cell_metrics(MAN, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert mf.cell_metrics(MAN, cell, True)


def test_configs_used_and_files_distinct():
    used = {c["config"] for c in CELLS}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_metric_resolves_and_moves_a_reported_metric(metric):
    m = next(x for x in MAN["per_layer"] if x["name"] == metric)
    assert callable(mf.metric_reader(metric).read)
    e2e = {x["name"] for x in MAN["end_to_end"]}
    assert m["moves"] in e2e
    for cell in m.get("workloads", []):
        assert cell in {c["name"] for c in CELLS}
        assert m["moves"] in [x["name"]
                              for x in mf.cell_metrics(MAN, cell, False)]


def test_layers_named_alike():
    # metrics of one layer give the same layer name, letter for letter
    by_prefix = {}
    for m in MAN["per_layer"]:
        by_prefix.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for k, v in by_prefix.items()
               if k not in ("mfu",)), by_prefix


def test_four_chip_cells_within_share():
    four = sum(c["chips"] == 4 for c in CELLS)
    assert four <= max(1, len(CELLS) // 4)
