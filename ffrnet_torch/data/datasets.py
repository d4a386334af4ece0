"""Datasets of the port, numpy on the host (ffrnet_tpu/data/datasets.py).

The data contracts are the reference's:

  * CASIA: `path label` lines of a clean list; each sample pairs the image
    with its synthetically masked twin, found by a file-name prefix scan of
    the same directory (`find_mask_twin`)
  * LFW: the standard `pairs.txt` (3 tokens = same person, 4 = different,
    the header line skipped); test_ocl_num in {0, 1, 2} swaps path1 and/or
    path2 for the masked twin
  * both: RGB -> BGR, a bicubic resize to 112x112 only when needed, the
    PAIRED horizontal flip, then [-1, 1] floats, or uint8 pixels with
    host_normalize=False (the card normalizes them,
    `ops.nn.images_to_unit_range`: the same values, a quarter of the bytes)

Samples are NHWC numpy arrays, as in the JAX package, so the two packages'
loaders give bit-equal batches for the same rng. Pillow decodes the
files; `use_native` takes the C++ decoder of `native/` instead
(`data/native.py`).
"""

from __future__ import annotations

import os
import sys
import warnings
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

IMG_SIZE = (112, 112)  # (W, H)


def parse_pairs_txt(pair_txt: str) -> Tuple[List[Tuple[str, str]], List[int]]:
    """The LFW pairs protocol: (pair names, labels), 1 = same person."""
    with open(pair_txt) as f:
        lines = f.readlines()[1:]
    pair_names, labels = [], []
    for line in lines:
        p = line.strip().split()
        if len(p) == 3:
            labels.append(1)
            name1 = f"{p[0]}/{p[0]}_{int(p[1]):04}.jpg"
            name2 = f"{p[0]}/{p[0]}_{int(p[2]):04}.jpg"
        elif len(p) == 4:
            labels.append(0)
            name1 = f"{p[0]}/{p[0]}_{int(p[1]):04}.jpg"
            name2 = f"{p[2]}/{p[2]}_{int(p[3]):04}.jpg"
        else:
            continue
        pair_names.append((name1, name2))
    return pair_names, labels


def find_mask_twin(data_root: str, image_path: str) -> Optional[str]:
    """The masked twin of `image_path` (`folder/file`): a file of the same
    directory whose name starts with the image's stem, or None."""
    folder, img = image_path.strip().split("/")
    num = img.strip().split(".")[0]
    for fname in _listdir_cached(os.path.join(data_root, folder)):
        if fname.startswith(num) and fname != img:
            return os.path.join(folder, fname)
    return None


@lru_cache(maxsize=65536)
def _listdir_cached(path: str) -> Tuple[str, ...]:
    return tuple(os.listdir(path))


def _load_rgb(path: str) -> np.ndarray:
    """Decode -> RGB HWC uint8, bicubic-resized to 112x112 if needed."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != IMG_SIZE:
        img = img.resize(IMG_SIZE, Image.BICUBIC)
    return np.asarray(img, dtype=np.uint8)


def _load_bgr(path: str) -> np.ndarray:
    """`_load_rgb` with the reference's BGR channel re-merge."""
    return _load_rgb(path)[:, :, ::-1]


def _to_unit(arr_u8: np.ndarray) -> np.ndarray:
    """ToTensor + Normalize([.5]*3, [.5]*3): uint8 -> float32 in [-1, 1]."""
    return (arr_u8.astype(np.float32) / 255.0 - 0.5) / 0.5


def _finish(arr_u8: np.ndarray, host_normalize: bool) -> np.ndarray:
    """host_normalize: the reference's float32 [-1, 1] sample; else the
    uint8 pixels, contiguous."""
    if host_normalize:
        return _to_unit(arr_u8)
    return np.ascontiguousarray(arr_u8)


def _native_ready(use_native) -> bool:
    """Resolve use_native ('auto' / True / False) against the C++ library:
    True raises when it does not load, 'auto' warns (once per call site)
    and takes Pillow."""
    if use_native is False:
        return False
    from ffrnet_torch.data import native

    ok = native.is_available()
    if not ok:
        if use_native is True:
            raise RuntimeError("native host library requested but unavailable "
                               "(make -C native failed: needs g++ and libjpeg)")
        warnings.warn("native host library unavailable (make -C native failed); "
                      "decoding with Pillow", RuntimeWarning, stacklevel=3)
    return ok


def _load_pair_native(path1: str, path2: str, flip: bool, host_normalize: bool = True):
    """Decode and prepare a JPEG pair with the C++ library (BGR, paired
    flip, bicubic resize; bit-equal to Pillow on 112x112 inputs)."""
    from ffrnet_torch.data import native

    with open(path1, "rb") as f:
        b1 = f.read()
    with open(path2, "rb") as f:
        b2 = f.read()
    out = native.decode_prep_batch([b1, b2], IMG_SIZE[::-1], bgr=True, flips=[flip, flip],
                                   strict=True, out_u8=not host_normalize)
    return out[0], out[1]


@dataclass
class CasiaPairs:
    """CASIA-WebFace paired clean/masked training set.

    data_root: the aligned image tree; img_list: `path label` lines.
    """

    data_root: str
    img_list: str
    flip_prob: float = 0.5
    num_classes: int = 10575
    use_native: object = "auto"  # True | False | 'auto' (C++ decode path)
    host_normalize: bool = True  # False: uint8 samples, normalized on the card

    def __post_init__(self):
        self.items: List[Tuple[str, int]] = []
        with open(self.img_list) as f:
            for line in f:
                if not line.strip():
                    continue
                path, label = line.strip().split()
                if not 0 <= int(label) < self.num_classes:
                    raise ValueError(
                        f"label {label} out of range [0, {self.num_classes}) for "
                        f"{path!r} — check --num_classes / the list file")
                self.items.append((path, int(label)))
        self._native = _native_ready(self.use_native)
        if self._native and not self.host_normalize:
            from ffrnet_torch.data import native

            if not native.has_u8():  # a stale library without uint8 output
                print("[warn] native library predates uint8 output — rebuild native/ "
                      "(make -C native); using Pillow", file=sys.stderr)
                self._native = False
        self._twin_cache: Dict[str, str] = {}

    def __len__(self):
        return len(self.items)

    def _twin(self, path: str) -> str:
        # resolved once per item: the prefix scan is O(directory size)
        twin = self._twin_cache.get(path)
        if twin is None:
            twin = find_mask_twin(self.data_root, path)
            if twin is None:
                raise FileNotFoundError(f"no masked twin for {path}")
            self._twin_cache[path] = twin
        return twin

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        path, label = self.items[idx]
        twin = self._twin(path)
        flip = rng.random() < self.flip_prob  # the paired flip: rng's first draw
        p1 = os.path.join(self.data_root, path)
        p2 = os.path.join(self.data_root, twin)
        if self._native:
            try:
                img, mask = _load_pair_native(p1, p2, flip, host_normalize=self.host_normalize)
                return {"img_non": img, "img_ocl": mask, "label": np.int32(label)}
            except RuntimeError:
                # a non-JPEG tree would otherwise read every file twice
                self._native = False
                print(f"[warn] native decode failed for {path!r} — using Pillow for "
                      "this dataset (non-JPEG files?)", file=sys.stderr)
        img = _load_bgr(p1)
        mask = _load_bgr(p2)
        if flip:
            img = img[:, ::-1]
            mask = mask[:, ::-1]
        return {"img_non": _finish(img, self.host_normalize),
                "img_ocl": _finish(mask, self.host_normalize),
                "label": np.int32(label)}


@dataclass
class LfwPairs:
    """LFW verification pairs with 0/1/2 masked substitutions."""

    face_root: str
    pairs_list: str
    test_ocl_num: int = 0
    flip_prob: float = 0.5  # the reference flips eval pairs too
    host_normalize: bool = True  # False: uint8 samples, normalized on the card

    def __post_init__(self):
        self.pair_names, self.labels = parse_pairs_txt(self.pairs_list)

    def __len__(self):
        return len(self.labels)

    def _masked(self, path: str) -> str:
        # evaluating the clean image as "masked" would inflate ocl accuracy
        twin = find_mask_twin(self.face_root, path)
        if twin is None:
            raise FileNotFoundError(
                f"no masked twin for {path!r} under {self.face_root!r} "
                f"(ocl={self.test_ocl_num}); generate masks or use ocl=0")
        return twin

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        path1, path2 = self.pair_names[idx]
        if self.test_ocl_num >= 1:
            path1 = self._masked(path1)
        if self.test_ocl_num >= 2:
            path2 = self._masked(path2)
        img1 = _load_bgr(os.path.join(self.face_root, path1))
        img2 = _load_bgr(os.path.join(self.face_root, path2))
        if self.flip_prob and rng.random() < self.flip_prob:
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
        return {"img1": _finish(img1, self.host_normalize),
                "img2": _finish(img2, self.host_normalize),
                "label": np.int32(self.labels[idx]),
                "idx": np.int32(idx)}


@dataclass
class MaskVerificationPairs:
    """Real-mask verification triples `masked nonmasked label`.

    The reference feeds these images as RGB, without the BGR re-merge of
    its CASIA/LFW loaders, though the encoder was trained on BGR; that is
    kept by default, and bgr=True applies the BGR protocol instead."""

    face_root: str
    img_dir: str = "masked_whn_112_align_v4"
    pair_txt: str = "masked_pairs_new_v4.txt"
    flip_prob: float = 0.5
    bgr: bool = False  # False: the reference's RGB
    host_normalize: bool = True  # False: uint8 samples, normalized on the card

    def __post_init__(self):
        self.pair_names: List[Tuple[str, str]] = []
        self.labels: List[int] = []
        with open(os.path.join(self.face_root, self.pair_txt)) as f:
            for line in f:
                p = line.strip().split()
                if len(p) < 3:
                    continue
                self.pair_names.append((p[0], p[1]))
                self.labels.append(int(p[2]))

    def __len__(self):
        return len(self.labels)

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        base = os.path.join(self.face_root, self.img_dir)
        load = _load_bgr if self.bgr else _load_rgb
        img1 = load(os.path.join(base, self.pair_names[idx][0]))
        img2 = load(os.path.join(base, self.pair_names[idx][1]))
        if self.flip_prob and rng.random() < self.flip_prob:
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
        return {"img1": _finish(img1, self.host_normalize),
                "img2": _finish(img2, self.host_normalize),
                "label": np.int32(self.labels[idx]),
                "idx": np.int32(idx)}


def gen_occlusion_mask(rng: np.random.Generator, img_hw: Tuple[int, int],
                       mask_hw: Tuple[int, int]) -> np.ndarray:
    """A random rectangular occlusion mask (1 = keep, 0 = occluded): a
    (mh, mw) rectangle placed uniformly inside img_hw, flush to the bottom
    and right edges included (integers() excludes its upper bound, hence
    the +1)."""
    h, w = img_hw
    mh, mw = mask_hw
    mask = np.ones((h, w, 1), np.float32)
    y = int(rng.integers(0, max(h - mh + 1, 1)))
    x = int(rng.integers(0, max(w - mw + 1, 1)))
    mask[y:y + mh, x:x + mw] = 0.0
    return mask


@dataclass
class SyntheticPairs:
    """Procedural identities for smoke tests and benches: each identity is
    a fixed random template in [-1, 1]; a sample adds noise, and its
    'masked' twin sets a lower-face box to -1 (a crude surgical-mask
    stand-in). The same seed gives the JAX package's samples."""

    num_identities: int = 16
    samples_per_id: int = 4
    seed: int = 0
    host_normalize: bool = True  # False: samples quantized to uint8
    noise: float = 0.05  # per-sample noise std

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.templates = rng.uniform(
            -1, 1, (self.num_identities, 112, 112, 3)).astype(np.float32)

    def __len__(self):
        return self.num_identities * self.samples_per_id

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        label = idx % self.num_identities
        img = self.templates[label] + self.noise * rng.standard_normal(
            (112, 112, 3)).astype(np.float32)
        mask = img.copy()
        mask[60:100, 20:92] = -1.0
        if not self.host_normalize:
            def q(x):  # the uint8 pixel grid
                return np.clip((x * 0.5 + 0.5) * 255.0, 0, 255).round().astype(np.uint8)
            img, mask = q(img), q(mask)
        return {"img_non": img, "img_ocl": mask, "label": np.int32(label)}
