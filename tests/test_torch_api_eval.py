"""ffrnet_torch.api / eval / checkpoint vs ffrnet_tpu on the CPU."""

import gzip

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ffrnet_torch.api import FFRNet as TorchFFRNet
from ffrnet_torch.checkpoint.convert import (backbone_state_dict,
                                             recnet_state_dict)
from ffrnet_torch.eval import lfw as t_lfw
from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.models.recnet import RecNetConfig, build_recnet
from ffrnet_tpu.api import FFRNet as JaxFFRNet
from ffrnet_tpu.eval import lfw as j_lfw

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    """The JAX package's FFRNet.random(0) and the port holding its weights."""
    jm = JaxFFRNet.random(seed=0)
    enc_p, enc_s, rec_p, rec_s = jax.device_get(
        (jm.enc_params, jm.enc_state, jm.rec_params, jm.rec_state))
    enc = build_backbone()
    enc.load_state_dict(backbone_state_dict(enc_p, enc_s))
    rec = build_recnet()
    rec.load_state_dict(recnet_state_dict(rec_p, rec_s))
    return jm, TorchFFRNet(enc, rec, RecNetConfig(), "cpu")


def _faces(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, 112, 112, 3), dtype=np.uint8)


# fp32 on both sides; the bound the JAX package holds two implementations of
# the same embedding to (tests/test_pallas_kernels.py)
EMB_TOL = dict(atol=5e-5, rtol=0)


def test_embed_and_verify_match_jax(models):
    jm, tm = models
    u8 = _faces(0, 4)
    fl = ((u8.astype(np.float32) / 255.0 - 0.5) / 0.5)
    raw_j, rect_j = jm.embed(fl)
    for images in (u8, fl):  # uint8 is normalized on the device
        raw_t, rect_t = tm.embed(images)
        np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), **EMB_TOL)
        np.testing.assert_allclose(rect_t.numpy(), np.asarray(rect_j), **EMB_TOL)
    # a mixed uint8/float pair: the uint8 side is normalized first
    s_j = jm.verify(u8[:2], fl[2:])
    s_t = tm.verify(u8[:2], fl[2:])
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)
    np.testing.assert_allclose(tm.verify(torch.from_numpy(fl[:2]), u8[2:]).numpy(),
                               s_t.numpy(), atol=1e-6)
    _, _, rmap = tm.featurize(u8[:1])
    assert tuple(rmap.shape) == (1, 7, 7, 512)  # NHWC at the boundary
    with pytest.raises(ValueError, match="same number"):
        tm.verify(u8[:2], u8[:3])


def test_evaluate_matches_jax(models):
    """lfw_tree-style pairs: noisy copies of one face are 'same', other
    faces 'different'; 10 pairs in two batches for the 10 folds."""
    jm, tm = models
    rng = np.random.default_rng(7)
    base = _faces(8, 6)

    def batches():
        for b in range(2):
            img1, img2, lab = [], [], []
            for k in range(5):
                i = (b * 5 + k) % 6
                same = k % 2 == 0
                j = i if same else (i + 1) % 6
                noise = rng.integers(-10, 10, base[j].shape)
                img1.append(base[i])
                img2.append(np.clip(base[j] + noise, 0, 255).astype(np.uint8))
                lab.append(int(same))
            yield {"img1": np.stack(img1), "img2": np.stack(img2),
                   "label": np.asarray(lab)}

    acc_j = jm.evaluate(batches())
    acc_t = tm.evaluate(batches())
    assert acc_t == pytest.approx(acc_j, abs=1e-6)


def _scores(case):
    rng = np.random.default_rng(11)
    n = 605 if case == "remainder" else 600
    s = rng.uniform(-1, 1, n).astype(np.float32)
    if case == "grid":  # scores exactly at grid points and one ulp around them
        t = j_lfw._T32[rng.integers(0, 400, 60)]
        s[:60] = t
        s[60:120] = np.nextafter(t, np.float32(2))
        s[120:180] = np.nextafter(t, np.float32(-2))
    if case == "ties":  # few distinct scores: many tied training accuracies
        s = np.round(s * 4) / 4
    labels = (rng.uniform(0, 1, n) < 0.5).astype(np.int32)
    return s, labels


@pytest.mark.parametrize("case", ["random", "grid", "ties", "remainder", "bfloat16"])
def test_kfold_bit_equal_to_jax(case):
    s, labels = _scores(case)
    if case == "bfloat16":
        js = jnp.asarray(s, jnp.bfloat16)
        ts = torch.from_numpy(s).to(torch.bfloat16)
    else:
        js, ts = jnp.asarray(s), torch.from_numpy(s)
    want = j_lfw.kfold_verification(js, jnp.asarray(labels))
    got = t_lfw.kfold_verification(ts, torch.from_numpy(labels))
    np.testing.assert_array_equal(got.fold_accuracies.numpy(),
                                  np.asarray(want.fold_accuracies))
    np.testing.assert_array_equal(got.best_thresholds.numpy(),
                                  np.asarray(want.best_thresholds))
    # the mean of 10 fp32 values may be summed in another order
    assert float(got.mean_accuracy) == pytest.approx(float(want.mean_accuracy), abs=1e-7)


def test_roc_helpers_match_jax():
    s, labels = _scores("ties")
    res = j_lfw.kfold_verification(jnp.asarray(s), jnp.asarray(labels))
    res_t = t_lfw.kfold_verification(torch.from_numpy(s), torch.from_numpy(labels))
    np.testing.assert_array_equal(t_lfw.misclassified_indices(s, labels, res_t),
                                  j_lfw.misclassified_indices(s, labels, res))
    for a, b in zip(t_lfw.exact_roc(s, labels), j_lfw.exact_roc(s, labels)):
        np.testing.assert_array_equal(a, b)
    assert t_lfw.roc_metrics(s, labels) == j_lfw.roc_metrics(s, labels)
    assert t_lfw.tar_at_far(s, labels) == j_lfw.tar_at_far(s, labels)
    f1, f2 = np.random.default_rng(2).standard_normal((2, 5, 512)).astype(np.float32)
    f2[0] = 0.0  # the 1e-8 epsilon keeps a zero embedding finite
    np.testing.assert_allclose(
        t_lfw.pair_cosine(torch.from_numpy(f1), torch.from_numpy(f2)).numpy(),
        np.asarray(j_lfw.pair_cosine(jnp.asarray(f1), jnp.asarray(f2))), atol=1e-7)


def _save(obj, path, gz):
    if gz:
        with gzip.open(path, "wb", compresslevel=1) as f:
            torch.save(obj, f)
    else:
        torch.save(obj, path)


@pytest.mark.parametrize("fmt", [".pth", ".pth.gzip"])
def test_from_pretrained_loads_torch_save_files(tmp_path, fmt):
    cfg = RecNetConfig(num_classes=16)
    src = TorchFFRNet.random(seed=3, cfg=cfg, device="cpu")
    enc_path, rec_path = tmp_path / f"se50{fmt}", tmp_path / f"FFRNet{fmt}"
    gz = fmt.endswith("gzip")
    _save({"state_dict": src.encoder.state_dict()}, enc_path, gz)
    _save({"RecNet": src.recnet.state_dict()}, rec_path, gz)
    loaded = TorchFFRNet.from_pretrained(str(enc_path), str(rec_path), cfg=cfg,
                                         fold_bn=False, device="cpu")
    x = _faces(4, 1)
    for a, b in zip(loaded.embed(x), src.embed(x)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    if gz:
        return
    folded = TorchFFRNet.from_pretrained(str(enc_path), str(rec_path), cfg=cfg,
                                         device="cpu")
    # folding reassociates each conv's affine: fp32 rounding only
    np.testing.assert_allclose(folded.embed(x)[0].numpy(), src.embed(x)[0].numpy(),
                               atol=5e-5)
    with pytest.raises(ValueError, match="classes"):
        TorchFFRNet.from_pretrained(str(enc_path), str(rec_path), device="cpu")


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchFFRNet.random(seed=0)
