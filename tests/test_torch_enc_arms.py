"""bench_train's frozen-encoder duel (--enc_arms, --rounds, --converge)
against ffrnet_tpu/tools/bench_train.py on the CPU: the records' keys, the
converge loop's batches, the interleaved rounds, the arms, and the
int8_static arm against JAX's static int8 tree
(tests/test_torch_enc_arms_train.py holds the float and folded arms'
train steps against JAX's). The duel's pieces are called directly: the
CLI would run dozens of full IR-SE50 steps. Weights are the port's seed-0
encoder, carried to JAX by ffrnet_tpu's torch_convert; inputs are made
with numpy from a seed; fp32. The scale caches live in a temporary
directory.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffrnet_torch.data.datasets import SyntheticPairs
from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.models.quantize import jax_leaf_path, quantized_sites
from ffrnet_torch.tools import bench_train
from ffrnet_tpu.checkpoint.torch_convert import backbone_from_torch
from ffrnet_tpu.data.datasets import SyntheticPairs as JSyntheticPairs
from ffrnet_tpu.models import irse as jirse
from ffrnet_tpu.models.optimize import fold_backbone_bn as j_fold
from ffrnet_tpu.models.quantize import quantize_encoder_params, quantized_leaf_items
from ffrnet_tpu.tools import int8_cache as j_int8_cache

torch.set_num_threads(1)

CPU = torch.device("cpu")
# the JAX records' keys (ffrnet_tpu/tools/bench_train.py:136-146, :179-183)
JAX_ARMS_KEYS = {"tool", "batch", "dtype", "scale_cache"} | {
    f"{m}_{k}" for m in ("step_ms", "imgs_per_sec") for k in bench_train.ARMS} | {
    "speedup_folded", "speedup_int8_static"}
JAX_CONVERGE_KEYS = {"tool", "steps", "batch", "num_classes", "dtype", "arms"}
CONVERGE_METRICS = {"TrainAcc", "triplet_gap", "TotalLoss"}
# the port's additions: the spread, the steps a round and the card
PORT_EXTRA_KEYS = {f"round_ms_{k}" for k in bench_train.ARMS} | {
    "steps_timed", "device", "nvidia_smi"}
# the bound of tests/test_torch_int8_model.py: int8 products exact in both
# packages, float layers between the sites an ulp apart now and then
MIN_COS = 0.999


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_records_have_the_jax_keys():
    round_ms = {"float": [12.0, 10.0, 11.0], "folded": [9.5, 9.0, 9.8],
                "int8_static": [20.0, 16.0, 18.0]}
    rec = bench_train.enc_arms_record(round_ms, batch=128, dtype="bf16", scale_cache="hit",
                                      iters=10, device=CPU)
    assert set(rec) == JAX_ARMS_KEYS | PORT_EXTRA_KEYS
    assert rec["tool"] == "bench_train_enc_arms" and rec["scale_cache"] == "hit"
    assert (rec["step_ms_float"], rec["step_ms_folded"], rec["step_ms_int8_static"]) == (
        10.0, 9.0, 16.0)  # each arm's best round
    assert rec["imgs_per_sec_float"] == pytest.approx(12800.0)
    assert rec["speedup_folded"] == pytest.approx(10.0 / 9.0)
    assert rec["speedup_int8_static"] == pytest.approx(10.0 / 16.0)
    assert rec["round_ms_int8_static"] == [20.0, 16.0, 18.0]
    assert (rec["device"], rec["nvidia_smi"]) == ("cpu", None)
    json.dumps(rec)


def test_converge_batches_are_the_jax_loops():
    """converge_batches against the JAX tool's loop (:166-172), three
    steps of 5, on the same SyntheticPairs(64 identities, 4 samples, seed
    3): the same indices, images and labels, bit for bit, and again for a
    second arm."""
    ds, jds = SyntheticPairs(num_identities=64, samples_per_id=4, seed=3), JSyntheticPairs(
        num_identities=64, samples_per_id=4, seed=3)
    order, srng = np.random.default_rng(1), np.random.default_rng(2)
    want = []
    for _ in range(3):
        idx = order.choice(len(jds), 5, replace=True)
        samples = [jds.get(int(i), srng) for i in idx]
        want.append({kk: np.stack([s[kk] for s in samples])
                     for kk in ("img_non", "img_ocl", "label")})
    for _ in range(2):  # each arm draws the same batches
        got = list(bench_train.converge_batches(ds, 5, 3))
        assert len(got) == 3
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_interleaved_rounds():
    """Warm-up calls of every arm first, then each round runs each arm's
    timed calls in turn; one median per round; the last metrics kept."""
    calls = []

    def step(k):
        def run():
            calls.append(k)
            return None, {"arm": k, "n": len(calls)}
        return run

    steps = {k: step(k) for k in ("a", "b", "c")}
    ms, metrics = bench_train.interleaved_rounds(steps, 2, 3, device=CPU, warmup=1)
    assert calls == ["a", "b", "c"] + (["a"] * 3 + ["b"] * 3 + ["c"] * 3) * 2
    assert set(ms) == {"a", "b", "c"} and all(len(v) == 2 and min(v) >= 0 for v in ms.values())
    assert metrics == {"a": {"arm": "a", "n": 15}, "b": {"arm": "b", "n": 18},
                       "c": {"arm": "c", "n": 21}}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX encoder params and state, the port's seed-0 encoder, its arms,
    the scale-cache file and the first call's status)."""
    enc = build_backbone(generator=torch.Generator().manual_seed(0))
    params, state = backbone_from_torch({k: v.numpy() for k, v in enc.state_dict().items()})
    cache = str(tmp_path_factory.mktemp("scales") / "scales_torch.json")
    arms, status = bench_train.encoder_arms(enc, "fp32", cache_file=cache)
    return params, state, enc, arms, cache, status


def test_encoder_arms(weights):
    """float is a copy of the encoder; folded has folded BNs and no int8;
    int8_static has 52 sites with static scales from the cache in
    tmp_path: a miss, then a hit with the same scales."""
    _, _, enc, arms, cache, status = weights
    assert set(arms) == set(bench_train.ARMS) and status.startswith("miss")
    assert arms["float"] is not enc and not quantized_sites(arms["float"])
    assert arms["float"].input_layer[0].bias is None
    assert arms["folded"].input_layer[0].bias is not None and not quantized_sites(arms["folded"])
    sites = quantized_sites(arms["int8_static"])
    assert len(sites) == 52 and all(s.x_scale is not None for _, s in sites)
    with open(cache) as f:
        assert len(json.load(f)["entries"]) == 1
    again, status2 = bench_train.encoder_arms(enc, "fp32", cache_file=cache)
    assert status2 == "hit"
    for (_, a), (_, b) in zip(sites, quantized_sites(again["int8_static"])):
        assert torch.equal(a.x_scale, b.x_scale)


def test_int8_static_arm_matches_jax_static_tree(weights, tmp_path):
    """The int8_static arm against the JAX tool's: fold_backbone_bn,
    quantize_encoder_params and static_encoder_tree (its own cache file in
    tmp_path, its calibration batch: 8 faces of default_rng(2), the port's
    too), on the same weights. Feature maps and embeddings of two held-out
    faces by cosine >= 0.999; each site's scale within 1e-5 relative."""
    params, state, _, arms, _, _ = weights
    fp, fs = j_fold(params, state)
    sp, status = j_int8_cache.static_encoder_tree(
        quantize_encoder_params(fp), fs, jnp.float32, cache_file=str(tmp_path / "scales.json"),
        cache_key=j_int8_cache.encoder_cache_key(fold_bn="1", dtype_name="fp32"))
    assert status.startswith("miss")
    leaves = dict(quantized_leaf_items(sp))
    for path, site in quantized_sites(arms["int8_static"]):
        assert site.x_scale.item() == pytest.approx(
            float(leaves[jax_leaf_path(path)]["x_scale"]), rel=1e-5), path
    x = np.random.default_rng(11).uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    fm_j, emb_j, _ = jax.jit(lambda x: jirse.apply(sp, fs, x, training=False))(jnp.asarray(x))
    with torch.no_grad():
        fm, emb = arms["int8_static"](torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    cos_e = _cos(emb.numpy(), np.asarray(emb_j))
    cos_f = _cos(fm.permute(0, 2, 3, 1).reshape(2, -1).numpy(), np.asarray(fm_j).reshape(2, -1))
    assert (cos_e >= MIN_COS).all() and (cos_f >= MIN_COS).all(), (cos_e, cos_f)


def test_converge_runs_and_reports(monkeypatch):
    """converge on a stand-in arm pair (a one-step horizon, 4 faces, 4
    classes): one fresh state per arm, the JAX record's keys, finite
    metrics, and both arms fed the same batches."""
    seen = {}
    real = bench_train.train_step

    def spy(encoder, state, batch, *, cfg):
        seen.setdefault(id(encoder), []).append(batch["label"].copy())
        assert cfg.recnet.num_classes == 4 and cfg.optimizer == "adam" and cfg.lr == 1e-3
        return real(encoder, state, batch, cfg=cfg)

    monkeypatch.setattr(bench_train, "train_step", spy)
    enc = build_backbone(generator=torch.Generator().manual_seed(0))
    arms = {"float": enc, "int8_static": copy.deepcopy(enc)}
    rec = bench_train.converge(arms, 1, batch=2, num_classes=4, dtype="fp32", device=CPU)
    assert set(rec) == JAX_CONVERGE_KEYS and rec["tool"] == "bench_train_enc_arms_converge"
    assert (rec["steps"], rec["batch"], rec["num_classes"], rec["dtype"]) == (1, 2, 4, "fp32")
    assert set(rec["arms"]) == set(bench_train.CONVERGE_ARMS)
    for m in rec["arms"].values():
        assert set(m) == CONVERGE_METRICS and all(np.isfinite(v) for v in m.values())
    a, b = seen.values()
    np.testing.assert_array_equal(a[0], b[0])
    assert rec["arms"]["float"] == rec["arms"]["int8_static"]  # the same weights, data, seed
