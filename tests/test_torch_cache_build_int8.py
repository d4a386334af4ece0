"""The int8 arm of the port's bench_cache_build against ffrnet_tpu on the
CPU: the tool's `prepare_int8_encoder` arm, calibrated on an 8-identity
SyntheticPairs, builds its feature cache, and the JAX package's
prepare_int8_encoder and build_feature_cache, on the same weights and the
same calibration images, hold it by cosine >= 0.999 (the bound of
test_torch_int8_model). XLA's int8 convolutions take seconds a face on the
CPU, so the JAX build covers the first sample: both streams, both flips."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ffrnet_torch.tools import bench_cache_build
from ffrnet_torch.train import INT8_CACHE_TAG
from ffrnet_torch.training.feature_cache import FEATURE_SHAPES, _fname, cache_meta
from ffrnet_tpu.checkpoint.torch_convert import backbone_from_torch
from ffrnet_tpu.data.datasets import SyntheticPairs as JSyntheticPairs
from ffrnet_tpu.train import prepare_int8_encoder as j_prepare_int8_encoder
from ffrnet_tpu.training.feature_cache import build_feature_cache as j_build_feature_cache

torch.set_num_threads(2)

IDS = 8
MIN_COS = 0.999
FILES = [(key, flip) for key in FEATURE_SHAPES for flip in (False, True)]


class _Head:
    """The first `k` samples of a flip-free paired dataset."""

    flip_prob = 0.0

    def __init__(self, dataset, k):
        self.dataset, self.k = dataset, k

    def __len__(self):
        return self.k

    def get(self, idx, rng):
        return self.dataset.get(idx, rng)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(dataset, fp32 encoder, the int8 arm's cache dir): the tool's arms on
    an 8-identity SyntheticPairs of one sample each, the int8 arm built in
    one batch."""
    ds = bench_cache_build.make_dataset(IDS, num_identities=IDS)
    enc, arms, cal_s = bench_cache_build.make_arms(ds, "fp32", "cpu")
    assert cal_s > 0 and set(arms) == {"float", "int8"}
    d = str(tmp_path_factory.mktemp("port_int8"))
    bench_cache_build.one_build(ds, enc, arms["int8"], batch=IDS, dtype_name="fp32",
                                cache_dir=d)
    return ds, enc, d


def _row_cosines(a, b):
    a, b = a.reshape(len(a), -1).astype(np.float64), b.reshape(len(b), -1).astype(np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_int8_arm_matches_jax_build(built, tmp_path):
    ds, enc, ours = built
    jax_encoder = backbone_from_torch({k: v.numpy() for k, v in enc.state_dict().items()})
    jds = JSyntheticPairs(num_identities=IDS, samples_per_id=1, seed=0)
    q_tree = j_prepare_int8_encoder(*jax_encoder, jds, "fp32")
    d = j_build_feature_cache(_Head(jds, 1), *jax.device_get(q_tree), str(tmp_path / "jax"),
                              batch_size=1, compute_dtype="fp32", num_threads=1)
    for key, flip in FILES:
        got = np.load(os.path.join(ours, _fname(key, flip)))
        assert got.shape == (IDS,) + FEATURE_SHAPES[key] and np.isfinite(got).all()
        cos = _row_cosines(got[:1], np.load(os.path.join(d, _fname(key, flip))))
        assert cos.min() >= MIN_COS, (_fname(key, flip), cos)


def test_int8_arm_fingerprint_is_not_the_float_arms(built):
    """The int8 arm's meta names the driver's variant tag, so a float build
    never finds an int8 build's cache, or the other way round."""
    ds, enc, ours = built
    with open(os.path.join(ours, "meta.json")) as f:
        meta = json.load(f)
    assert meta == cache_meta(ds, enc, "fp32", INT8_CACHE_TAG)
    assert meta["fingerprint"] != cache_meta(ds, enc, "fp32")["fingerprint"]
