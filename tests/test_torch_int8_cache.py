"""The port's tools/int8_cache.py: the cases of tests/test_int8_cache.py
against the port, and the cache held against ffrnet_tpu/tools/int8_cache.py
on the CPU: the file format both ways, the walk order, the committed
`.int8_scales.json`'s site paths, a miss -> hit on a calibrated IR-SE50 and
RecNet, keys that fingerprint the weights, and keys that never equal the
JAX package's.

No test writes the tracked `.int8_scales.json`: the port's default file is
pointed at tmp_path, and the tracked file's bytes are checked unchanged."""

import copy
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax

from ffrnet_tpu.models import irse as jirse
from ffrnet_tpu.models import recnet as jrecnet
from ffrnet_tpu.models.quantize import (quantize_encoder_params, quantize_recnet_params,
                                        quantized_leaf_items as jax_leaf_items)
from ffrnet_tpu.tools import int8_cache as jcache
from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.models.optimize import fold_backbone_bn
from ffrnet_torch.models.quantize import (calibrate_activation_scales, quantize_encoder,
                                          quantize_recnet, quantized_sites)
from ffrnet_torch.models.recnet import build_recnet
from ffrnet_torch.tools import int8_cache as cache
from ffrnet_torch.tools.int8_cache import (_rehydrate, _resolve_cached, encoder_cache_key,
                                           load_scales, quantized_leaf_items, recnet_cache_key,
                                           save_scales, weights_fingerprint)

torch.set_num_threads(1)

TRACKED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       ".int8_scales.json")


def _digest():
    with open(TRACKED, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(autouse=True)
def cache_in_tmp(tmp_path, monkeypatch):
    """The port's default file under tmp_path; the tracked JAX file untouched."""
    before = _digest()
    monkeypatch.setattr(cache, "default_cache_file", lambda: str(tmp_path / "scales.json"))
    yield
    assert _digest() == before


@pytest.fixture(scope="module")
def enc():
    return build_backbone(generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def qenc(enc):
    return quantize_encoder(fold_backbone_bn(enc))


@pytest.fixture(scope="module")
def qrec():
    return quantize_recnet(build_recnet(generator=torch.Generator().manual_seed(1)))


@pytest.fixture(scope="module")
def jax_trees():
    """The JAX package's quantized IR-SE50 and RecNet trees, shapes only."""
    key = jax.random.PRNGKey(0)
    return (jax.eval_shape(lambda k: quantize_encoder_params(jirse.init(k)[0]), key),
            jax.eval_shape(lambda k: quantize_recnet_params(jrecnet.init(k)[0]), key))


def _paths(items):
    return [p for p, _ in items]


def _scales(paths, seed=0):
    rng = np.random.default_rng(seed)
    return {p: float(np.float32(v)) for p, v in zip(paths, rng.uniform(1e-3, 1.0, len(paths)))}


# --- the cases of tests/test_int8_cache.py ----------------------------------


def test_load_missing_file(tmp_path):
    assert load_scales(str(tmp_path / "nope.json"), "k") is None


def test_save_load_roundtrip(tmp_path):
    f = str(tmp_path / "c.json")
    save_scales(f, "k1", {"a/w": 1.5, "b/w": 2.5})
    save_scales(f, "k2", {"c/w": 3.0})
    assert load_scales(f, "k1") == {"a/w": 1.5, "b/w": 2.5}
    assert load_scales(f, "k2") == {"c/w": 3.0}
    assert load_scales(f, "k3") is None


def test_save_overwrites_same_key(tmp_path):
    f = str(tmp_path / "c.json")
    save_scales(f, "k", {"a/w": 1.0})
    save_scales(f, "k", {"a/w": 2.0})
    assert load_scales(f, "k") == {"a/w": 2.0}


@pytest.mark.parametrize("content", ["{not json", '{"key": "old", "x_scales": [0.25]}'],
                         ids=["corrupt", "legacy_single_entry"])
def test_corrupt_file_tolerated_on_save(tmp_path, content):
    """A corrupt file, or the JAX package's oldest single-entry payload
    (whose keys no port key equals), holds no entry and is replaced."""
    f = str(tmp_path / "c.json")
    with open(f, "w") as fh:
        fh.write(content)
    if content.startswith('{"key"'):
        assert load_scales(f, "old") is None
    save_scales(f, "k", {"a/w": 1.0})
    assert load_scales(f, "k") == {"a/w": 1.0}
    with open(f) as fh:
        assert json.load(fh) == {"entries": {"k": {"a/w": 1.0}}}


def test_keys_are_distinct_and_config_sensitive(qenc, qrec, enc):
    e = encoder_cache_key(qenc, dtype_name="bf16")
    r = recnet_cache_key(qrec, enc, dtype_name="bf16")
    assert e != r
    assert recnet_cache_key(qrec, enc, dtype_name="fp32") != r
    assert recnet_cache_key(qrec, enc, dtype_name="bf16", cal_batch=16) != r
    assert encoder_cache_key(qenc, dtype_name="bf16", seed=3) != e
    assert encoder_cache_key(qenc, dtype_name="bf16") == e


def _nudged(q):
    out = copy.deepcopy(q)
    site = quantized_sites(out)[7][1]
    with torch.no_grad():
        site.weight_q.view(-1)[0] += 1 if site.weight_q.view(-1)[0] < 127 else -1
    return out


@pytest.mark.parametrize("change", ["same_init", "unfolded", "bf16", "init_seed", "one_weight"])
def test_fingerprint_follows_the_weights(tmp_path, enc, qenc, change):
    """The key names the weights, not how they were made: the same init
    gives the same key, and an unfolded, bf16, other-seed or one-level
    different encoder another one, so its scales miss and are never those
    of the folded fp32 model."""
    other = {
        "same_init": lambda: quantize_encoder(fold_backbone_bn(
            build_backbone(generator=torch.Generator().manual_seed(0)))),
        "unfolded": lambda: quantize_encoder(enc),
        "bf16": lambda: quantize_encoder(fold_backbone_bn(enc).to(torch.bfloat16)),
        "init_seed": lambda: quantize_encoder(fold_backbone_bn(
            build_backbone(generator=torch.Generator().manual_seed(1)))),
        "one_weight": lambda: _nudged(qenc),
    }[change]()
    f = str(tmp_path / "c.json")
    key = encoder_cache_key(qenc, dtype_name="fp32")
    save_scales(f, key, _scales(_paths(quantized_leaf_items(qenc))))
    other_key = encoder_cache_key(other, dtype_name="fp32")
    assert (other_key == key) == (change == "same_init")
    assert (load_scales(f, other_key) is None) == (change != "same_init")


def test_recnet_key_follows_its_encoder(qrec, enc):
    """RecNet calibrates on its encoder's feature maps: another encoder,
    another key; the same weights, the same fingerprint."""
    enc1 = build_backbone(generator=torch.Generator().manual_seed(1))
    assert (recnet_cache_key(qrec, enc, dtype_name="fp32")
            != recnet_cache_key(qrec, enc1, dtype_name="fp32"))
    assert weights_fingerprint(qrec, enc) == weights_fingerprint(copy.deepcopy(qrec), enc)
    assert weights_fingerprint(qrec, enc) != weights_fingerprint(enc, qrec)


def test_resolve_cached_path_keyed_exact_match(qenc):
    items = quantized_leaf_items(qenc)
    cached = _scales(_paths(items))
    assert _resolve_cached(cached, items) == cached


def test_resolve_cached_stale_on_site_set_change(qenc):
    items = quantized_leaf_items(qenc)
    cached = _scales(_paths(items))
    renamed = dict(cached)
    renamed["OLD/conv/w"] = renamed.pop("body/3/res/conv1/w")
    assert _resolve_cached(renamed, items) is None
    removed = dict(cached)
    del removed["output/linear/w"]
    assert _resolve_cached(removed, items) is None
    assert _resolve_cached({**cached, "c/conv/w": 0.1}, items) is None


def test_rehydrate_bakes_by_path_not_position(qenc):
    by_path = _scales(_paths(quantized_leaf_items(qenc)), seed=1)
    out = _rehydrate(qenc, by_path)
    for path, site in quantized_leaf_items(out):
        assert site.x_scale.dtype == torch.float32
        assert float(site.x_scale) == np.float32(by_path[path])
    assert all(s.x_scale is None for _, s in quantized_sites(qenc))  # source untouched


def test_rehydrate_count_mismatch_raises(qenc):
    with pytest.raises(ValueError, match="count mismatch"):
        _rehydrate(qenc, {"body/0/res/conv1/w": 0.5})


def test_committed_cache_matches_the_ports_sites(qenc, qrec):
    """The JAX package's committed .int8_scales.json (read only) is path
    keyed with exactly the port's 52 encoder and 15 RecNet site paths."""
    with open(TRACKED) as f:
        entries = json.load(f)["entries"]
    assert len(entries) == 3
    enc_paths, rec_paths = set(_paths(quantized_leaf_items(qenc))), set(
        _paths(quantized_leaf_items(qrec)))
    assert (len(enc_paths), len(rec_paths)) == (52, 15)
    for key, v in entries.items():
        assert isinstance(v, dict), key
        assert set(v) == (rec_paths if key.startswith("recnet-") else enc_paths), key


# --- against the JAX package ------------------------------------------------


def test_walk_order_is_the_jax_packages(qenc, qrec, jax_trees):
    jenc, jrec = jax_trees
    assert _paths(quantized_leaf_items(qenc)) == _paths(jax_leaf_items(jenc))
    assert _paths(quantized_leaf_items(qrec)) == _paths(jax_leaf_items(jrec))
    # not the module order
    assert _paths(quantized_leaf_items(qenc)) != [
        cache.jax_leaf_path(n) for n, _ in quantized_sites(qenc)]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_file_format_crosses_both_ways(tmp_path, qenc, qrec, jax_trees, writer):
    """A file either package writes resolves to the same dict in the other,
    for the whole IR-SE50 and RecNet site sets."""
    f = str(tmp_path / "x.json")
    for i, model in enumerate((qenc, qrec)):
        by_path = _scales(_paths(quantized_leaf_items(model)), seed=i)
        (jcache.save_scales if writer == "jax" else save_scales)(f, f"k{i}", by_path)
    for i, (model, jtree) in enumerate(zip((qenc, qrec), jax_trees)):
        want = _scales(_paths(quantized_leaf_items(model)), seed=i)
        ours = _resolve_cached(load_scales(f, f"k{i}"), quantized_leaf_items(model))
        theirs = jcache._resolve_cached(jcache.load_scales(f, f"k{i}"), jax_leaf_items(jtree),
                                        [])
        assert ours == theirs == want


def test_keys_never_equal_the_jax_packages(qenc, qrec, enc):
    ours, theirs = set(), set()
    for dt in ("fp32", "bf16"):
        for cal in (8, 16):
            for seed in (2, 3):
                kw = dict(dtype_name=dt, cal_batch=cal, seed=seed)
                ours |= {encoder_cache_key(qenc, **kw), recnet_cache_key(qrec, enc, **kw)}
                for fold in ("0", "1"):
                    theirs |= {jcache.encoder_cache_key(fold_bn=fold, **kw),
                               jcache.recnet_cache_key(fold_bn=fold, **kw)}
    assert len(ours) == 16 and not ours & theirs


def test_default_file_is_the_ports_own(monkeypatch):
    monkeypatch.undo()
    path = cache.default_cache_file()
    assert os.path.basename(path) == ".int8_scales_torch.json"
    assert os.path.dirname(path) == os.path.dirname(TRACKED)


def test_encoder_miss_then_hit_bit_equal(tmp_path, qenc):
    """A CPU miss calibrates and saves; the hit rehydrates the same fp32
    scales bit for bit, and they are calibrate_activation_scales' on the
    same batch; the same embeddings follow. A removed path is stale."""
    f, key = str(tmp_path / "c.json"), encoder_cache_key(qenc, dtype_name="fp32", cal_batch=2)
    kw = dict(cache_file=f, cache_key=key, cal_batch=2)
    miss, s1 = cache.static_encoder_tree(qenc, torch.float32, **kw)
    hit, s2 = cache.static_encoder_tree(qenc, torch.float32, **kw)
    assert (s1, s2) == (cache.STATUS_MISS, cache.STATUS_HIT)
    want = calibrate_activation_scales(qenc, [cache.uniform_faces(2, 2, torch.float32,
                                                                      "cpu")])
    scales = [[s.x_scale for _, s in quantized_leaf_items(m)] for m in (miss, hit, want)]
    for a, b, c in zip(*scales):
        assert a.item() == b.item() == c.item()
    x = cache.uniform_faces(1, 9, torch.float32, "cpu")
    with torch.inference_mode():
        assert torch.equal(miss(x)[1], hit(x)[1])
    entry = load_scales(f, key)
    del entry["body/5/res/conv2/w"]
    save_scales(f, key, entry)
    _, s3 = cache.static_encoder_tree(qenc, torch.float32, **kw)
    assert s3 == cache.STATUS_STALE
    assert len(load_scales(f, key)) == 52


def test_recnet_miss_then_hit_and_stale(tmp_path, qrec, enc):
    f, key = str(tmp_path / "c.json"), recnet_cache_key(qrec, enc, dtype_name="fp32",
                                                        cal_batch=2)
    g = torch.Generator().manual_seed(5)
    proj = torch.randn(3, 512, generator=g)

    def enc_fwd(x):  # a cheap stand-in encoder: (N, 3, 112, 112) -> (N, 512, 7, 7)
        pooled = torch.nn.functional.adaptive_avg_pool2d(x, 7)
        return torch.einsum("nchw,cd->ndhw", pooled, proj)

    kw = dict(cache_file=f, cache_key=key, cal_batch=2)
    miss, s1 = cache.static_recnet_tree(qrec, enc_fwd, torch.float32, **kw)
    hit, s2 = cache.static_recnet_tree(qrec, enc_fwd, torch.float32, **kw)
    assert (s1, s2) == (cache.STATUS_MISS, cache.STATUS_HIT)
    for (pa, a), (pb, b) in zip(quantized_leaf_items(miss), quantized_leaf_items(hit)):
        assert pa == pb and a.x_scale.item() == b.x_scale.item()
    entry = load_scales(f, key)
    del entry["merge/r/conv1/conv/w"]
    save_scales(f, key, entry)
    assert cache.static_recnet_tree(qrec, enc_fwd, torch.float32, **kw)[1] == cache.STATUS_STALE
