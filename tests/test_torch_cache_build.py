"""The port's bench_cache_build against ffrnet_tpu on the CPU: the tool's
float arm builds the feature cache of an 8-identity SyntheticPairs, and the
JAX package's build_feature_cache on the same weights holds it file by file
at 1e-5 abs + rel (the int8 arm: test_torch_cache_build_int8.py). main's
JSON keys are the JAX tool's."""

import json
import os

import numpy as np
import pytest
import torch

from ffrnet_torch.tools import bench_cache_build
from ffrnet_torch.training.feature_cache import FEATURE_SHAPES, _fname
from ffrnet_tpu.checkpoint.torch_convert import backbone_from_torch
from ffrnet_tpu.data.datasets import SyntheticPairs as JSyntheticPairs
from ffrnet_tpu.training.feature_cache import build_feature_cache as j_build_feature_cache

torch.set_num_threads(2)

IDS = 8
TOL = 1e-5
# ffrnet_tpu/tools/bench_cache_build.py:88-96
JAX_KEYS = {"tool", "n", "batch", "dtype", "calibration_s_onetime", "pass_s", "median_s",
            "samples_per_s", "speedup_int8"}
FILES = [(key, flip) for key in FEATURE_SHAPES for flip in (False, True)]


@pytest.fixture(scope="module")
def arms():
    """(dataset, fp32 encoder, arms, calibration seconds) of the tool, on
    an 8-identity SyntheticPairs of one sample each."""
    ds = bench_cache_build.make_dataset(IDS, num_identities=IDS)
    assert len(ds) == IDS
    return (ds,) + bench_cache_build.make_arms(ds, "fp32", "cpu")


@pytest.fixture(scope="module")
def float_cache(arms, tmp_path_factory):
    """The float arm's cache dir: one build, one batch."""
    ds, enc, tool_arms, _ = arms
    d = str(tmp_path_factory.mktemp("port_float"))
    secs = bench_cache_build.one_build(ds, enc, tool_arms["float"], batch=IDS,
                                       dtype_name="fp32", cache_dir=d)
    assert secs > 0 and os.path.exists(os.path.join(d, "meta.json"))
    return d


@pytest.fixture(scope="module")
def jax_encoder(arms):
    """The tool's encoder weights as the JAX package's trees."""
    enc = arms[1]
    return backbone_from_torch({k: v.numpy() for k, v in enc.state_dict().items()})


def _load(d, key, flip):
    return np.load(os.path.join(d, _fname(key, flip)))


def test_float_arm_matches_jax_build(float_cache, jax_encoder, tmp_path):
    jds = JSyntheticPairs(num_identities=IDS, samples_per_id=1, seed=0)
    d = j_build_feature_cache(jds, *jax_encoder, str(tmp_path / "jax"), batch_size=IDS,
                              compute_dtype="fp32", num_threads=2)
    ours = float_cache
    for key, flip in FILES:
        got, want = _load(ours, key, flip), _load(d, key, flip)
        assert got.shape == want.shape == (IDS,) + FEATURE_SHAPES[key]
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=_fname(key, flip))
    np.testing.assert_array_equal(np.load(os.path.join(ours, "label.npy")),
                                  np.load(os.path.join(d, "label.npy")))


def test_main_json_keys(capsys, monkeypatch):
    """main on a 2-identity dataset (make_dataset patched), one round: the
    JAX tool's keys, one time per arm and round, the medians' ratio."""
    real = bench_cache_build.make_dataset
    monkeypatch.setattr(bench_cache_build, "make_dataset", lambda n: real(n, num_identities=2))
    out = bench_cache_build.main(["--device", "cpu", "--n", "2", "--batch", "2", "--rounds",
                                  "1", "--dtype", "fp32"])
    printed = capsys.readouterr()
    assert json.loads(printed.out.strip().splitlines()[-1]) == json.loads(json.dumps(out))
    assert "[warm] float" in printed.err and "[round 0] int8" in printed.err
    assert set(out) == JAX_KEYS
    assert (out["tool"], out["n"], out["batch"], out["dtype"]) == ("bench_cache_build", 2, 2,
                                                                   "fp32")
    assert out["calibration_s_onetime"] > 0
    for key in ("pass_s", "median_s", "samples_per_s"):
        assert set(out[key]) == {"float", "int8"}
    assert all(len(v) == 1 and v[0] > 0 for v in out["pass_s"].values())
    med = out["median_s"]
    assert med == {k: v[0] for k, v in out["pass_s"].items()}
    for k, v in med.items():
        assert out["samples_per_s"][k] == pytest.approx(2 / v, rel=1e-2, abs=0.05)
    assert out["speedup_int8"] == pytest.approx(med["float"] / med["int8"], abs=2e-3)
