"""BENCHMARK.json and the benchmark's data files hold to the contract's
shape: names, units, counts, the files each entry names, and a reader or
driver for every metric and traffic kind."""

import json
import re
from pathlib import Path

import pytest

from benchmarks import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmarks/") and (ROOT / c["file"]).exists()
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_workload_entry_and_file(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
    assert w["chips"] == 1
    spec = harness.load_spec(cell)
    assert spec.workload["why"] == w["why"]
    assert set(spec.workload["limits"]) and all(v > 0 for v in spec.workload["limits"].values())
    assert (harness.HERE / "traffic" / f"{spec.kind}.py").exists()
    reported = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert spec.per_layer, "every cell reports a per-layer metric"
    for m in spec.per_layer:
        assert m["moves"] in reported, (cell, m["name"])


def test_pairs_unique_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert all(c in CELLS for c in m.get("workloads", CELLS))
        assert harness.reader(m["name"]).read


def test_files_under_paths_are_named_from_name_characters():
    for path in (ROOT / "benchmarks").rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or rel.startswith("benchmarks/_cache"):
            continue
        assert all(NAME.match(part) for part in rel.split("/")), rel
