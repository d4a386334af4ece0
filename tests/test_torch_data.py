"""The port's datasets and loader (ffrnet_torch.data) against ffrnet_tpu.data
on the CPU, on tiny JPEG trees built in tmp_path: samples and batches must
be bit-equal for the same rng, seed and epoch."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from ffrnet_torch.data import datasets as P
from ffrnet_torch.data import native as p_native
from ffrnet_torch.data.pipeline import BatchLoader, SliceDataset
from ffrnet_tpu.data import datasets as J
from ffrnet_tpu.data import native as j_native
from ffrnet_tpu.data.pipeline import BatchLoader as JBatchLoader


def assert_samples_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def casia_list(root, tmp_path):
    """A CASIA list over the lfw_tree fixture's clean images."""
    lines = []
    for label, name in enumerate(sorted(os.listdir(root))):
        if (root / name).is_dir():
            for i in (1, 2):
                lines.append(f"{name}/{name}_{i:04}.jpg {label}\n")
    lst = tmp_path / "casia_list.txt"
    lst.write_text("".join(lines))
    return lst


@pytest.fixture
def maskver_tree(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    root = tmp_path / "maskver"
    d = root / "masked_whn_112_align_v4"
    d.mkdir(parents=True)
    lines = []
    for i in range(4):
        for side in ("m", "n"):
            arr = rng.integers(0, 256, (100, 90, 3), dtype=np.uint8)  # resized on load
            Image.fromarray(arr).save(d / f"{i}_{side}.jpg")
        lines.append(f"{i}_m.jpg {i}_n.jpg {i % 2}\n")
    (root / "masked_pairs_new_v4.txt").write_text("".join(lines))
    return root


def test_parse_pairs_and_find_mask_twin(lfw_tree):
    root, pairs = lfw_tree
    assert P.parse_pairs_txt(str(pairs)) == J.parse_pairs_txt(str(pairs))
    for name in ("Person_0/Person_0_0001.jpg", "Person_3/Person_3_0002.jpg"):
        assert P.find_mask_twin(str(root), name) == J.find_mask_twin(str(root), name)
        assert P.find_mask_twin(str(root), name).endswith("_m.jpg")


@pytest.mark.parametrize("host_normalize", [False, True])
@pytest.mark.parametrize("flip_prob", [0.0, 0.5, 1.0])
def test_casia_pairs_equal_jax(lfw_tree, tmp_path, host_normalize, flip_prob):
    root, _ = lfw_tree
    lst = casia_list(root, tmp_path)
    kw = dict(flip_prob=flip_prob, use_native=False, host_normalize=host_normalize)
    p, j = P.CasiaPairs(str(root), str(lst), **kw), J.CasiaPairs(str(root), str(lst), **kw)
    assert p.items == j.items and len(p) == 12
    for i in range(len(p)):
        assert_samples_equal(p.get(i, np.random.default_rng((7, i))),
                             j.get(i, np.random.default_rng((7, i))))


def test_casia_pairs_checks_labels_and_twins(lfw_tree, tmp_path):
    root, _ = lfw_tree
    lst = casia_list(root, tmp_path)
    with pytest.raises(ValueError, match="out of range"):
        P.CasiaPairs(str(root), str(lst), num_classes=3, use_native=False)
    os.remove(root / "Person_0" / "Person_0_0001_m.jpg")
    P._listdir_cached.cache_clear()
    ds = P.CasiaPairs(str(root), str(lst), use_native=False)
    with pytest.raises(FileNotFoundError, match="no masked twin"):
        ds.get(0, np.random.default_rng(0))


@pytest.mark.parametrize("host_normalize", [False, True])
@pytest.mark.parametrize("ocl", [0, 1, 2])
def test_lfw_pairs_equal_jax(lfw_tree, ocl, host_normalize):
    root, pairs = lfw_tree
    kw = dict(test_ocl_num=ocl, flip_prob=0.5, host_normalize=host_normalize)
    p, j = P.LfwPairs(str(root), str(pairs), **kw), J.LfwPairs(str(root), str(pairs), **kw)
    assert len(p) == len(j) == 60
    for i in range(0, 60, 7):
        a = p.get(i, np.random.default_rng((3, i)))
        assert_samples_equal(a, j.get(i, np.random.default_rng((3, i))))
        assert a["idx"] == i


def test_lfw_pairs_missing_twin_fails_loudly(lfw_tree):
    root, pairs = lfw_tree
    os.remove(root / "Person_0" / "Person_0_0001_m.jpg")
    P._listdir_cached.cache_clear()
    ds = P.LfwPairs(str(root), str(pairs), test_ocl_num=1, flip_prob=0.0)
    with pytest.raises(FileNotFoundError, match="ocl=1"):
        ds.get(0, np.random.default_rng(0))


@pytest.mark.parametrize("bgr", [False, True])
@pytest.mark.parametrize("host_normalize", [False, True])
def test_mask_verification_pairs_equal_jax(maskver_tree, bgr, host_normalize):
    kw = dict(flip_prob=0.5, bgr=bgr, host_normalize=host_normalize)
    p = P.MaskVerificationPairs(str(maskver_tree), **kw)
    j = J.MaskVerificationPairs(str(maskver_tree), **kw)
    assert p.labels == j.labels == [0, 1, 0, 1]
    for i in range(len(p)):
        assert_samples_equal(p.get(i, np.random.default_rng(i)),
                             j.get(i, np.random.default_rng(i)))


def test_mask_verification_rgb_quirk(maskver_tree):
    rng = np.random.default_rng(0)
    rgb = P.MaskVerificationPairs(str(maskver_tree), flip_prob=0.0).get(0, rng)
    bgr = P.MaskVerificationPairs(str(maskver_tree), flip_prob=0.0, bgr=True).get(0, rng)
    np.testing.assert_array_equal(rgb["img1"], bgr["img1"][..., ::-1])


def test_gen_occlusion_mask_equal_jax_and_reaches_the_edges():
    corners = set()
    for seed in range(200):
        for img_hw, mask_hw in (((112, 112), (40, 60)), ((7, 7), (3, 2)), ((5, 5), (9, 9))):
            a = P.gen_occlusion_mask(np.random.default_rng(seed), img_hw, mask_hw)
            b = J.gen_occlusion_mask(np.random.default_rng(seed), img_hw, mask_hw)
            np.testing.assert_array_equal(a, b)
            if img_hw == (7, 7):
                assert a.sum() == 49 - 6
                corners.add((a[-1, :, 0] == 0).any())
                corners.add(("right", (a[:, -1, 0] == 0).any()))
    # flush to the bottom and to the right edge both occur (the +1 fix)
    assert True in corners and ("right", True) in corners


class Draws:
    """A dataset of index and rng draws: shows the index order and the
    per-sample RNG streams."""

    def __len__(self):
        return 37

    def get(self, idx, rng):
        return {"idx": np.int32(idx), "x": rng.standard_normal(3).astype(np.float32),
                "y": rng.random(3)}


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("process", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("pack", [None, {"xy": ("x", "y")}])
def test_batch_loader_equal_jax(shuffle, drop_last, process, pack):
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=11, num_threads=3,
              process_index=process[0], process_count=process[1], pack=pack)
    p, j = BatchLoader(Draws(), 6, **kw), JBatchLoader(Draws(), 6, **kw)
    assert len(p) == len(j)
    for epoch in (0, 3):
        np.testing.assert_array_equal(p._epoch_indices(epoch), j._epoch_indices(epoch))
        for start in (0, 2):
            got = list(p.epoch(epoch, start_batch=start))
            want = list(j.epoch(epoch, start_batch=start))
            assert len(got) == len(want) == len(p) - start
            for a, b in zip(got, want):
                assert_samples_equal(a, b)


def test_batch_loader_images_equal_jax(lfw_tree):
    root, pairs = lfw_tree
    ds = P.LfwPairs(str(root), str(pairs), test_ocl_num=2, flip_prob=0.5,
                    host_normalize=False)
    jds = J.LfwPairs(str(root), str(pairs), test_ocl_num=2, flip_prob=0.5,
                     host_normalize=False)
    pack = {"imgs": ("img1", "img2")}
    kw = dict(shuffle=True, drop_last=True, seed=4, num_threads=2, process_index=0,
              process_count=1)
    got = list(BatchLoader(ds, 16, pack=pack, **kw).epoch(1, start_batch=1))
    want = list(JBatchLoader(jds, 16, pack=pack, **kw).epoch(1, start_batch=1))
    assert len(got) == 2 and got[0]["imgs"].shape == (16, 2, 112, 112, 3)
    for a, b in zip(got, want):
        assert_samples_equal(a, b)
    # device="cpu" gives the same numbers as torch tensors
    on_cpu = list(BatchLoader(ds, 16, pack=pack, device="cpu", **kw).epoch(1, start_batch=1))
    for a, b in zip(on_cpu, got):
        for k in b:
            assert isinstance(a[k], torch.Tensor) and a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), b[k])


def test_batch_loader_start_batch_skips_without_decoding():
    touched = []

    class Tracking(Draws):
        def get(self, idx, rng):
            touched.append(idx)
            return super().get(idx, rng)

    full = list(BatchLoader(Tracking(), 4, seed=5).epoch(1))
    touched.clear()
    tail = list(BatchLoader(Tracking(), 4, seed=5).epoch(1, start_batch=3))
    assert len(tail) == len(full) - 3
    for a, b in zip(full[3:], tail):
        assert_samples_equal(a, b)
    assert len(touched) == 4 * len(tail)
    with pytest.raises(ValueError, match="start_batch"):
        next(BatchLoader(Tracking(), 4).epoch(0, start_batch=99))


def test_batch_loader_rejects_bad_process_args():
    with pytest.raises(ValueError, match="out of range"):
        BatchLoader(Draws(), 4, process_index=2, process_count=2)
    with pytest.raises(ValueError, match="divide evenly"):
        BatchLoader(Draws(), 5, process_index=0, process_count=2)


def test_batch_loader_propagates_decode_errors():
    class Broken(Draws):
        def get(self, idx, rng):
            if idx == 9:
                raise OSError(f"corrupt sample {idx}")
            return super().get(idx, rng)

    with pytest.raises(OSError, match="corrupt sample 9"):
        list(BatchLoader(Broken(), 4, shuffle=False, num_threads=2).epoch(0))


def test_batch_loader_abandoned_generator_cleans_up():
    before = set(threading.enumerate())
    for _ in range(10):
        gen = BatchLoader(Draws(), 4, prefetch=1, num_threads=2).epoch(0)
        next(gen)
        gen.close()  # abandoned mid-epoch
    deadline = time.time() + 10
    while time.time() < deadline and set(threading.enumerate()) - before:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - before


def test_slice_dataset():
    ds = SliceDataset(Draws(), slice(5, 12))
    assert len(ds) == 7
    assert ds.get(0, np.random.default_rng(0))["idx"] == 5
    with pytest.raises(IndexError):
        ds.get(7, np.random.default_rng(0))
    with pytest.raises(ValueError, match="contiguous"):
        SliceDataset(Draws(), slice(0, 10, 2))


@pytest.fixture
def native_lib():
    if not p_native.is_available():
        pytest.skip("make -C native failed: no native library to test")
    return p_native


@pytest.mark.parametrize("host_normalize", [False, True])
def test_native_path_equal_jax_native(lfw_tree, tmp_path, native_lib, host_normalize):
    root, _ = lfw_tree
    lst = casia_list(root, tmp_path)
    kw = dict(flip_prob=0.5, use_native=True, host_normalize=host_normalize)
    p, j = P.CasiaPairs(str(root), str(lst), **kw), J.CasiaPairs(str(root), str(lst), **kw)
    assert p._native and j._native
    pil = P.CasiaPairs(str(root), str(lst), flip_prob=0.5, use_native=False,
                       host_normalize=host_normalize)
    for i in range(len(p)):
        a = p.get(i, np.random.default_rng(i))
        assert_samples_equal(a, j.get(i, np.random.default_rng(i)))
        assert_samples_equal(a, pil.get(i, np.random.default_rng(i)))  # 112x112: bit-exact
    imgs = [np.random.default_rng(5).integers(0, 256, (60, 80, 3), dtype=np.uint8)]
    for out_u8 in (False, True):
        np.testing.assert_array_equal(
            native_lib.prep_batch(imgs, flips=[True], out_u8=out_u8),
            j_native.prep_batch(imgs, flips=[True], out_u8=out_u8))
    with pytest.raises(ValueError, match="3 channels"):
        native_lib.prep_batch([np.zeros((112, 112), np.uint8)])
    with pytest.raises(RuntimeError, match="decodes failed"):
        native_lib.decode_prep_batch([b"not a jpeg"])
