"""The port's bench_int8_budget on the CPU at the smallest flags the
10-fold sweep takes (one seed, two steps, 4 classes, 10 pairs, fp32): the
JSON keys against the JAX tool's, the summary recomputed from the rows, and
--out under tmp_path (the int8 encoder's CPU twin, a float64 im2col product,
sets the time)."""

import json

import numpy as np
import torch

from ffrnet_torch.tools import bench_int8_budget

torch.set_num_threads(1)

TINY = ["--device", "cpu", "--dtype", "fp32", "--batch", "2", "--num_classes", "4",
        "--eval_pairs", "10", "--cal_images", "2"]
# ffrnet_tpu/tools/bench_int8_budget.py:173-181 (rows), :193-200, :201-211
BUDGET_KEYS = {"tool", "config", "rows", "summary", "wall_s"}
ROW_KEYS = {"seed", "margin", "split", "float_rect", "float_raw", "int8_rect", "int8_raw",
            "d_rect", "d_raw"}
SUMMARY_KEYS = {"worst_abs_d_rect", "worst_abs_d_raw", "mean_d_rect", "mean_d_raw"}


def _run(main, argv, capsys):
    out = main(argv)
    return out, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_budget_cpu(tmp_path, capsys):
    path = tmp_path / "sub" / "budget.json"
    out, printed = _run(bench_int8_budget.main, TINY + [
        "--seeds", "1", "--train_steps", "2", "--margins", "1.0", "--out", str(path)], capsys)
    assert printed == {k: out[k] for k in ("tool", "summary", "wall_s")}
    with open(path) as f:
        assert json.load(f) == out
    assert set(out) == BUDGET_KEYS and out["tool"] == "bench_int8_budget"
    rows = out["rows"]
    assert [(r["seed"], r["margin"], r["split"]) for r in rows] == [
        (0, 1.0, s) for s in ("enc_only", "recnet_only", "all")]
    for r in rows:
        assert set(r) == ROW_KEYS
        for k in ("float_rect", "float_raw", "int8_rect", "int8_raw"):
            assert 0.0 <= r[k] <= 1.0
        for d, a, b in (("d_rect", "int8_rect", "float_rect"),
                        ("d_raw", "int8_raw", "float_raw")):
            assert abs(r[d] - (r[a] - r[b])) <= 1e-4 + 1e-9
    assert set(out["summary"]) == {f"m1.0/{s}" for s in ("enc_only", "recnet_only", "all")}
    for key, v in out["summary"].items():
        assert set(v) == SUMMARY_KEYS
        sel = [r for r in rows if f"m{r['margin']}/{r['split']}" == key]
        assert v["worst_abs_d_rect"] == max(abs(r["d_rect"]) for r in sel)
        assert v["worst_abs_d_raw"] == max(abs(r["d_raw"]) for r in sel)
        assert v["mean_d_rect"] == round(float(np.mean([r["d_rect"] for r in sel])), 4)
        assert v["mean_d_raw"] == round(float(np.mean([r["d_raw"] for r in sel])), 4)


def test_summary_over_seeds():
    rows = [{"seed": s, "margin": m, "split": sp, "d_rect": d, "d_raw": -d}
            for s, d in ((0, 0.01), (1, -0.03), (2, 0.005))
            for m in (0.75, 1.0) for sp in bench_int8_budget.SPLITS]
    summary = bench_int8_budget.summarize(rows, [0.75, 1.0])
    assert len(summary) == 6
    for v in summary.values():
        assert v == {"worst_abs_d_rect": 0.03, "worst_abs_d_raw": 0.03,
                     "mean_d_rect": -0.005, "mean_d_raw": 0.005}


