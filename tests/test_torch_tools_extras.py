"""The port's train_synthetic example and its bench_eval and bench_driver
tools on the CPU, at small sizes: their printed lines and keys against the
JAX counterparts', the example's batches against examples/train_synthetic.py's
numpy stream, and bench_eval's folds against evaluate_pairs."""

import contextlib
import io
import json
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

import jax

torch.set_num_threads(1)

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "examples", "train_synthetic.py")
STEP_LINE = re.compile(r"^step +(\d+)  total=(\S+)  acc=(\d\.\d{3})$")


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_train_synthetic_example(capsys):
    from ffrnet_torch.examples import train_synthetic

    train_synthetic.main(["2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    for i, line in enumerate(lines):  # f"step {i:4d}  total={...:.4f}  acc={...:.3f}"
        m = STEP_LINE.match(line)
        assert m and int(m.group(1)) == i, line
        assert np.isfinite(float(m.group(2))) and 0 <= float(m.group(3)) <= 1


def test_train_synthetic_batches_are_the_jax_examples(monkeypatch):
    """The JAX example's main with jax.jit as identity and train_step as a
    recorder: the batches it would train on, bit for bit."""
    import ffrnet_tpu.training.trainer as j_trainer
    from ffrnet_tpu.models import irse
    from ffrnet_torch.examples.train_synthetic import synthetic_batches

    seen = []

    def record(enc_params, enc_state, state, batch, *, cfg):
        seen.append({k: np.asarray(v) for k, v in batch.items()})
        return state, {"TotalLoss": 0.0, "TrainAcc": 0.0}

    # the frozen encoder and the state are never read: skip their init
    monkeypatch.setattr(irse, "init", lambda key: (None, None))
    monkeypatch.setattr(j_trainer, "create_train_state", lambda key, cfg: None)
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: fn)
    monkeypatch.setattr(j_trainer, "train_step", record)
    monkeypatch.setattr(sys, "argv", ["train_synthetic.py", "3"])
    runpy.run_path(EXAMPLE, run_name="example")["main"]()
    ours = list(synthetic_batches(3))
    assert len(seen) == len(ours) == 3
    for j, t in zip(seen, ours):
        assert set(j) == set(t)
        for k in j:
            assert j[k].dtype == t[k].dtype
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


BENCH_EVAL_KEYS = {"metric", "value", "unit", "pairs", "batch", "dtype", "sync_per_batch",
                   "pairs_per_sec", "all_times"}


def _bench_eval(sync_per_batch, monkeypatch):
    """bench_eval.main at 20 pairs in batches of 10 on the CPU -> (its
    dict, what it printed, [(batches, results)] of each evaluate_pairs
    call)."""
    from ffrnet_torch.eval import runner
    from ffrnet_torch.tools import bench_eval

    calls = []
    evaluate = runner.evaluate_pairs

    def spy(score_fn, batches, **kw):
        res = evaluate(score_fn, batches, **kw)
        calls.append((batches, res))
        return res

    with monkeypatch.context() as m:
        m.setattr(runner, "evaluate_pairs", spy)
        argv = ["--pairs", "20", "--batch", "10", "--dtype", "fp32", "--repeats", "1",
                "--device", "cpu"] + (["--sync_per_batch"] if sync_per_batch else [])
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            out = bench_eval.main(argv)
    return out, printed.getvalue(), calls


@pytest.fixture(scope="module")
def bench_eval_device_scores():
    mp = pytest.MonkeyPatch()
    try:
        return _bench_eval(False, mp)
    finally:
        mp.undo()


def _folds_equal(got, want):
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("sync_per_batch", [False, True])
def test_bench_eval(sync_per_batch, bench_eval_device_scores, monkeypatch):
    """Keys and values of the printed line; the staged pairs are the JAX
    tool's numpy stream; every pass's folds equal evaluate_pairs' on the
    device scores, also when each batch's scores went to the host first."""
    out, printed, calls = (_bench_eval(True, monkeypatch) if sync_per_batch
                           else bench_eval_device_scores)
    assert _last_json(printed) == out
    assert set(out) == BENCH_EVAL_KEYS
    assert out["metric"] == "lfw_eval_pass_seconds" and out["unit"] == "s"
    assert (out["pairs"], out["batch"], out["dtype"]) == (20, 10, "fp32")
    assert out["sync_per_batch"] is sync_per_batch and len(out["all_times"]) == 1
    assert out["value"] > 0 and out["pairs_per_sec"] > 0
    assert len(calls) == 2  # the first pass and one repeat

    batches = calls[0][0]
    rng = np.random.default_rng(0)
    assert len(batches) == 2
    for b in batches:
        for k in ("img1", "img2"):
            np.testing.assert_array_equal(
                b[k].numpy(), rng.uniform(-1, 1, (10, 112, 112, 3)).astype(np.float32))
        np.testing.assert_array_equal(b["label"], rng.integers(0, 2, 10).astype(np.int64))

    want = bench_eval_device_scores[2][0][1]
    for _, got in calls:
        _folds_equal(got, want)


BENCH_DRIVER_KEYS = {"metric", "value", "unit", "ms_per_iter", "batch", "host_normalize",
                     "upload_only", "mb_per_batch", "dtype", "pack"}


@pytest.mark.parametrize("upload_only", [0, 1])
def test_bench_driver(upload_only, capsys):
    from ffrnet_torch.tools import bench_driver

    out = bench_driver.main(["--batch", "8", "--iters", "2", "--warmup", "1", "--n_thread", "2",
                             "--upload_only", str(upload_only), "--device", "cpu"])
    assert _last_json(capsys.readouterr().out) == out
    assert set(out) == BENCH_DRIVER_KEYS
    assert out["metric"] == "driver_loop_imgs_per_sec" and out["unit"] == "imgs/s"
    assert out["value"] > 0 and out["ms_per_iter"] > 0
    assert out["upload_only"] is bool(upload_only) and out["batch"] == 8
    assert out["host_normalize"] is False and out["pack"] is False and out["dtype"] == "fp32"
    assert out["mb_per_batch"] == round(2 * 8 * 112 * 112 * 3 / 1e6, 2)  # uint8 pairs
