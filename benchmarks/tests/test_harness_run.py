"""A run's result line, its refusal without a card, and its import guard."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmarks import harness
from benchmarks.tests.tiny import run_tiny

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())
         ["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_schema(cell):
    result, checks = run_tiny(cell)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert isinstance(result["correct"], bool) and result["attempted"] >= 1
    assert isinstance(result["failed"], int) and 0 <= result["failed"]
    spec = harness.load_spec(cell)
    assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end}
    for m in spec.end_to_end:
        got = result["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert {"platform", "kind", "count"} <= set(result["device"])
    assert set(result["checks"]) == set(spec.workload["limits"])
    assert [c[0] for c in checks] == list(result["checks"])
    json.dumps(result)


def test_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(harness.ROOT))
    proc = subprocess.run([sys.executable, "-m", "benchmarks.run", "--workload",
                           CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=harness.ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "card" in proc.stderr or "cuda" in proc.stderr.lower()


def test_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "benchmarks.run", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_import_guard(monkeypatch):
    harness.import_guard()
    monkeypatch.setitem(sys.modules, "ffrnet_tpu_lookalike", sys)
    harness.import_guard()  # a longer name is another package
    for name in ("jax", "jaxlib.xla", "ffrnet_tpu.api", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
        with pytest.raises(harness.ForbiddenImport):
            harness.import_guard()
        monkeypatch.delitem(sys.modules, name)


def test_no_run_loads_jax():
    code = ("import sys\nfrom benchmarks.tests.tiny import run_tiny\n"
            f"run_tiny({CELLS[-1]!r})\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'ffrnet_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, check=True,
                         capture_output=True, text=True, timeout=600).stdout
    assert out.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    """One short run of the first cell on the card, as the driver makes it."""
    proc = subprocess.run([sys.executable, "-m", "benchmarks.run", "--workload", CELLS[0],
                           "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
