"""The port's bench_stages against ffrnet_tpu's on the CPU: the analytic
FLOP counts bit for bit, the timed stem and stage slices against the JAX
package's unit loop on the same weights (fp32, N=2), and a run of the tool
at the smallest size with its JSON keys against the JAX tool's. Also: each
tool of the last slices (bench_stages, bench_cache_build, parity_check,
bench_train) defaults to the card and raises without one."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffrnet_torch.checkpoint.convert import backbone_state_dict
from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.tools import (bench_cache_build, bench_stages, bench_train, int8_cache,
                                parity_check)
from ffrnet_tpu.models import irse as jirse
from ffrnet_tpu.ops import nn as jops
from ffrnet_tpu.tools import bench_stages as jbench_stages

torch.set_num_threads(1)

# ffrnet_tpu/tools/bench_stages.py:124-175 (rows; --iters <= 4 adds
# warp_gather), :177-219 (--stem_duel 1), :235-261 (--int8 1); warp_tiled
# and warp_rowcrop are XLA strategies of the TPU, and the port times
# warp_full in their place
JAX_ROWS = {"stem", "stage1", "stage2", "stage3", "stage4", "encoder_full", "recnet",
            "cp2tform_solve", "warp_tiled", "warp_band", "warp_rowcrop", "warp_gather",
            "stem_duel", "encoder_int8", "recnet_int8", "int8_stage_shares"}
PORT_ROWS = (JAX_ROWS - {"warp_tiled", "warp_rowcrop"}) | {"warp_full"}
SHARE_STAGES = {"cp2tform_solve", "warp_band", "encoder_int8", "recnet_int8"}
STEM_DUEL_ARMS = {"prod", "im2col", "padc"}
TOL = 1e-5
# (name, unit range) of the rows held against the JAX package's loop, and
# the NHWC input shape of each
ROWS = [("stem", None, (2, 112, 112, 3))] + [
    (f"stage{i}", (lo, hi), (2, hw, hw, cin))
    for i, (lo, hi, hw, cin, _) in enumerate(jbench_stages._STAGES_50, start=1)]


@pytest.mark.parametrize("batch", [1, 256])
def test_stage_flops_are_the_jax_tools(batch):
    assert bench_stages.stage_flops(batch) == jbench_stages.stage_flops(batch)
    assert bench_stages._STAGES_50 == jbench_stages._STAGES_50


def _random_bn(tree, rng):
    """The tree with every BN's scale, bias, mean and var drawn at random
    (the JAX init's BNs are identities, which would hide a swapped pair)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
            elif k in ("bias", "mean"):
                out[k] = rng.normal(0, 0.3, np.shape(v)).astype(np.float32)
            else:
                out[k] = _random_bn(v, rng)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_random_bn(v, rng) for v in tree)
    return np.asarray(tree)


@pytest.fixture(scope="module")
def weights():
    """(JAX params, JAX state, the port's encoder on the same weights)."""
    params, state = jax.device_get(jirse.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    params, state = _random_bn(params, rng), _random_bn(state, rng)
    enc = build_backbone()
    enc.load_state_dict(backbone_state_dict(params, state))
    return params, state, enc


@pytest.mark.parametrize("name,units,shape", ROWS, ids=[r[0] for r in ROWS])
def test_stage_rows_match_jax_unit_loop(weights, name, units, shape):
    """bench_stages' stem and body[lo:hi] rows against the JAX tool's
    (ffrnet_tpu/tools/bench_stages.py:118-136) at 1e-5 abs + rel, fp32."""
    params, state, enc = weights
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    if units is None:
        fn = bench_stages.stem_fn(enc)

        def jfn(x):
            y = jops.conv2d(x, params["input"]["conv"]["w"], params["input"]["conv"].get("b"),
                            stride=1, padding=1)
            y, _ = jirse._bn(params["input"]["bn"], state["input"]["bn"], y, False)
            return jops.prelu(y, params["input"]["prelu"]["slope"], axis=-1)
    else:
        lo, hi = units
        fn = bench_stages.stage_fn(enc, lo, hi)
        cfgs = jirse.unit_configs(50)[lo:hi]

        def jfn(x):
            for p_, s_, (_, _, stride) in zip(params["body"][lo:hi], state["body"][lo:hi],
                                              cfgs):
                x, _ = jirse._apply_unit(p_, s_, x, stride, "ir_se", False)
            return x
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x)))
    with torch.inference_mode():
        got = fn(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=TOL, rtol=TOL)


def test_bench_stages_cpu(capsys, tmp_path, monkeypatch):
    """main at batch 2, one call a row, fp32, --int8 1 --stem_duel 1: the
    JAX tool's rows (warp_full for warp_tiled and warp_rowcrop), TFLOP/s on
    the rows with a FLOP count, the shares summing to sum_ms, the stem
    duel's three arms within 1e-5 of prod, the scale cache in tmp_path."""
    cache = tmp_path / "scales.json"
    monkeypatch.setattr(int8_cache, "default_cache_file", lambda: str(cache))
    out = bench_stages.main(["--device", "cpu", "--batch", "2", "--iters", "1", "--dtype",
                             "fp32", "--int8", "1", "--stem_duel", "1"])
    printed = capsys.readouterr()
    assert json.loads(printed.out.strip().splitlines()[-1]) == json.loads(json.dumps(out))
    assert "enc scale cache: miss" in printed.err and "recnet scale cache: miss" in printed.err
    assert set(out) == {"batch", "dtype", "results"}
    assert (out["batch"], out["dtype"]) == (2, "fp32")
    res = out["results"]
    assert set(res) == PORT_ROWS
    flops = bench_stages.stage_flops(2)
    assert set(res["stem_duel"]) == STEM_DUEL_ARMS
    for arm, entry in res["stem_duel"].items():
        assert set(entry) == {"ms", "max_abs_err"} and entry["ms"] > 0, arm
        assert entry["max_abs_err"] <= TOL, arm
    for name, entry in res.items():
        if name in ("int8_stage_shares", "stem_duel"):
            continue
        assert entry["ms"] > 0
        assert ("tflops" in entry) == (name in flops), name
        if name in flops:
            assert entry["tflops"] == round(flops[name] / (entry["ms"] * 1e-3) / 1e12, 1)
    shares = res["int8_stage_shares"]
    assert set(shares) == SHARE_STAGES | {"sum_ms"}
    assert shares["sum_ms"] == pytest.approx(sum(shares[k]["ms"] for k in SHARE_STAGES),
                                             abs=1e-6)
    assert sum(shares[k]["share"] for k in SHARE_STAGES) == pytest.approx(1.0, abs=2e-3)
    for k in SHARE_STAGES:
        assert shares[k]["ms"] == res[k]["ms"]
    with open(cache) as f:
        assert len(json.load(f)["entries"]) == 2


@pytest.mark.parametrize("tool,argv", [
    (bench_stages, []), (bench_cache_build, []),
    (parity_check, ["--encoder", "se50.pth"]), (bench_train, [])],
    ids=["bench_stages", "bench_cache_build", "parity_check", "bench_train"])
def test_tools_default_to_the_card(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main(argv)
