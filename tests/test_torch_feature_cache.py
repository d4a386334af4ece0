"""The port's frozen-encoder feature cache (ffrnet_torch.training.feature_cache)
on the CPU at N=4: its features against encode_frozen, its rebuild rules,
the paired-flip draw, a cached step against the raw-image step, and its
files against ffrnet_tpu's cache of the same tree and weights."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from ffrnet_torch.checkpoint.convert import backbone_state_dict
from ffrnet_torch.data.datasets import CasiaPairs
from ffrnet_torch.data.pipeline import BatchLoader
from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.models.recnet import RecNetConfig
from ffrnet_torch.training import feature_cache as fc
from ffrnet_torch.training.trainer import (TrainerConfig, create_train_state, encode_frozen,
                                           train_step, train_step_from_features)

torch.set_num_threads(2)

KEYS = tuple(fc.FEATURE_SHAPES)


@pytest.fixture(scope="module")
def casia(tmp_path_factory):
    """(root, list): 2 identities x 2 aligned JPEGs, each with its _m twin."""
    from PIL import Image

    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("casia") / "faces"
    lines = []
    for label in range(2):
        d = root / f"{label:07d}"
        d.mkdir(parents=True)
        for i in (1, 2):
            img = rng.integers(0, 256, (112, 112, 3), dtype=np.uint8)
            Image.fromarray(img).save(d / f"{i:03d}.jpg")
            Image.fromarray(img // 2).save(d / f"{i:03d}_m.jpg")
            lines.append(f"{label:07d}/{i:03d}.jpg {label}\n")
    lst = root.parent / "list.txt"
    lst.write_text("".join(lines))
    return str(root), str(lst)


@pytest.fixture(scope="module")
def jax_encoder():
    from ffrnet_tpu.models import irse

    return jax.device_get(irse.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def encoder(jax_encoder):
    enc = build_backbone()
    enc.load_state_dict(backbone_state_dict(*jax_encoder))
    return enc.eval()


def flipfree(casia):
    return CasiaPairs(*casia, flip_prob=0.0, use_native=False)


@pytest.fixture(scope="module")
def cache_fp32(casia, encoder, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fc32"))
    return fc.build_feature_cache(flipfree(casia), encoder, d, batch_size=4)


def encode_variants(casia, encoder):
    """encode_frozen of the whole flip-free batch, unflipped and flipped,
    NHWC maps (the layout on disk)."""
    batch = next(iter(BatchLoader(flipfree(casia), 4, shuffle=False, drop_last=False,
                                  device="cpu")))
    out = {}
    for flip in (False, True):
        b = {k: (v.flip(2) if flip and k != "label" else v) for k, v in batch.items()}
        f = encode_frozen(encoder, b)
        out[flip] = {k: (f[k].permute(0, 2, 3, 1) if f[k].ndim == 4 else f[k]) for k in KEYS}
    return out


def test_features_read_back_equal_encode_frozen(casia, encoder, cache_fp32):
    want = encode_variants(casia, encoder)
    cached = fc.CachedFeatureDataset(cache_fp32, flip_prob=0.5)
    assert len(cached) == 4
    for idx in range(4):
        for seed in range(3):
            flip = np.random.default_rng(seed).random() < 0.5
            got = cached.get(idx, np.random.default_rng(seed))
            assert got["label"] == idx // 2
            for k in KEYS:
                assert got[k].dtype == np.float32 and got[k].shape == fc.FEATURE_SHAPES[k]
                np.testing.assert_array_equal(got[k], want[flip][k][idx].numpy(), err_msg=k)


def test_flip_draws_match_casia_pairs(casia, cache_fp32):
    """The cache's flip is the rng's first draw, as CasiaPairs.get's is: the
    same rng picks the flipped features exactly where it flips the images."""
    cached = fc.CachedFeatureDataset(cache_fp32, flip_prob=0.5)
    raw = CasiaPairs(*casia, flip_prob=0.5, use_native=False)
    plain = flipfree(casia)
    flips = []
    for seed in range(12):
        img = raw.get(1, np.random.default_rng(seed))["img_non"]
        ref = plain.get(1, np.random.default_rng(seed))["img_non"]
        img_flip = bool((img != ref).any())
        np.testing.assert_array_equal(img, ref[:, ::-1] if img_flip else ref)
        got = cached.get(1, np.random.default_rng(seed))["embed_non"]
        np.testing.assert_array_equal(got, cached._read("embed_non", img_flip, 1))
        flips.append(img_flip)
    assert 0 < sum(flips) < len(flips)


def test_rebuild_is_idempotent_and_invalidated(casia, encoder, tmp_path):
    d = str(tmp_path / "fc")
    fc.build_feature_cache(flipfree(casia), encoder, d, batch_size=4)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    stamp = {n: os.stat(os.path.join(d, n)).st_mtime_ns for n in os.listdir(d)}
    fc.build_feature_cache(flipfree(casia), encoder, d, batch_size=4)
    assert stamp == {n: os.stat(os.path.join(d, n)).st_mtime_ns for n in os.listdir(d)}
    assert not os.path.exists(os.path.join(d, "building.lock"))

    # a new encoder weight invalidates the cache and rebuilds it
    other = build_backbone()
    other.load_state_dict(encoder.state_dict())
    other.eval()
    with torch.no_grad():
        other.output_layer[3].bias.add_(0.5)
    fc.build_feature_cache(flipfree(casia), other, d, batch_size=4)
    with open(os.path.join(d, "meta.json")) as f:
        meta2 = json.load(f)
    assert meta2["fingerprint"] != meta["fingerprint"] and meta2["n"] == 4
    e0 = fc.CachedFeatureDataset(d, flip_prob=0.0).get(0, np.random.default_rng(0))
    assert not np.array_equal(
        e0["embed_non"], encode_variants(casia, encoder)[False]["embed_non"][0].numpy())

    # the same list under another image root has another fingerprint
    root2 = str(tmp_path / "faces2")
    shutil.copytree(casia[0], root2)
    moved = CasiaPairs(root2, casia[1], flip_prob=0.0, use_native=False)
    assert fc.cache_fingerprint(moved, encoder) != fc.cache_fingerprint(flipfree(casia),
                                                                        encoder)
    assert fc.cache_fingerprint(flipfree(casia), encoder) == meta["fingerprint"]
    assert fc.cache_fingerprint(flipfree(casia), encoder, extra="x") != meta["fingerprint"]


def test_crashed_build_never_looks_complete(casia, encoder, tmp_path, monkeypatch):
    from ffrnet_torch.training import trainer

    d = str(tmp_path / "fc")
    fc.build_feature_cache(flipfree(casia), encoder, d, batch_size=2)
    real = trainer.encode_frozen
    calls = []

    def crash_on_second_batch(enc, batch):
        calls.append(1)
        if len(calls) > 2:  # two flip variants per batch
            raise RuntimeError("simulated crash")
        return real(enc, batch)

    monkeypatch.setattr(trainer, "encode_frozen", crash_on_second_batch)
    other = build_backbone(generator=torch.Generator().manual_seed(5))
    with pytest.raises(RuntimeError, match="simulated crash"):
        fc.build_feature_cache(flipfree(casia), other.eval(), d, batch_size=2)
    # the stale meta went before the arrays were truncated
    assert not os.path.exists(os.path.join(d, "meta.json"))
    assert fc.lock_age_s(d) is not None
    with pytest.raises(FileNotFoundError):
        fc.CachedFeatureDataset(d)
    monkeypatch.setattr(trainer, "encode_frozen", real)
    fc.build_feature_cache(flipfree(casia), encoder, d, batch_size=2)
    assert fc.lock_age_s(d) is None and len(fc.CachedFeatureDataset(d)) == 4


def test_flipping_dataset_is_rejected(casia, encoder, tmp_path):
    with pytest.raises(ValueError, match="flip-free"):
        fc.build_feature_cache(CasiaPairs(*casia, use_native=False), encoder,
                               str(tmp_path / "fc"))


def test_bf16_round_trip(casia, encoder, tmp_path):
    d = fc.build_feature_cache(flipfree(casia), encoder, str(tmp_path / "fc"),
                               batch_size=4, compute_dtype="bf16")
    assert np.load(os.path.join(d, "featmap_non_v1.npy")).dtype == np.uint16
    bf = build_backbone()
    bf.load_state_dict(encoder.state_dict())
    want = encode_variants(casia, bf.eval().to(torch.bfloat16))
    cached = fc.CachedFeatureDataset(d, flip_prob=1.0)
    batch = next(iter(BatchLoader(cached, 4, shuffle=False, drop_last=False, device="cpu")))
    for k in KEYS:
        assert batch[k].dtype == torch.bfloat16
        assert torch.equal(batch[k], want[True][k]), k


def test_cached_step_equals_raw_image_step(casia, encoder, cache_fp32):
    """One train_step_from_features on a cached batch equals one
    train_step on the raw images the same loader seed gives (flips
    included)."""
    cfg = TrainerConfig(optimizer="sgd", lr=1e-2, recnet=RecNetConfig(num_classes=8))
    kw = dict(shuffle=True, drop_last=True, seed=3, device="cpu")
    raw = next(BatchLoader(CasiaPairs(*casia, use_native=False), 4, **kw).epoch(1))
    cached = next(BatchLoader(fc.CachedFeatureDataset(cache_fp32), 4, **kw).epoch(1))
    assert torch.equal(raw["label"], cached["label"])
    states = []
    for run in ("raw", "cached"):
        state = create_train_state(cfg, seed=1, device="cpu")
        if run == "raw":
            _, m = train_step(encoder, state, raw, cfg=cfg)
        else:
            _, m = train_step_from_features(state, fc.to_nchw(cached), cfg=cfg)
        states.append((m, state.model.state_dict()))
    (m_raw, sd_raw), (m_c, sd_c) = states
    for k in m_raw:
        assert abs(float(m_raw[k]) - float(m_c[k])) <= 1e-5 * (1 + abs(float(m_raw[k]))), k
    for k, v in sd_raw.items():
        if v.is_floating_point():
            torch.testing.assert_close(sd_c[k], v, atol=1e-6, rtol=0, msg=k)


def test_cache_files_equal_jax(casia, jax_encoder, cache_fp32, tmp_path):
    """The JAX package's cache of the same tree and weights: the same file
    names, shapes and layout (NHWC), the values within 1e-5."""
    from ffrnet_tpu.data.datasets import CasiaPairs as JCasiaPairs
    from ffrnet_tpu.training.feature_cache import build_feature_cache as j_build

    jd = j_build(JCasiaPairs(*casia, flip_prob=0.0, use_native=False), *jax_encoder,
                 str(tmp_path / "jfc"), batch_size=4)
    names = sorted(n for n in os.listdir(jd) if n.endswith(".npy"))
    assert names == sorted(n for n in os.listdir(cache_fp32) if n.endswith(".npy"))
    for n in names:
        a, b = np.load(os.path.join(cache_fp32, n)), np.load(os.path.join(jd, n))
        assert a.shape == b.shape and a.dtype == b.dtype, n
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=n)
