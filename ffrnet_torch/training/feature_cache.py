"""On-disk frozen-encoder feature cache for RecNet-only training epochs
(ffrnet_tpu/training/feature_cache.py).

The IR-SE50 encoder is frozen for the whole run, so its outputs are a pure
function of (sample, flip): computed once and streamed back, every later
epoch is a RecNet-only step (`train_step_from_features`). Both flip
variants are cached, the flipped one made by `torch.flip` of the same
image batch on the card (equal, pixel for pixel, to the host loader's
img[:, ::-1]), so `CachedFeatureDataset` keeps the paired flip's
per-(epoch, sample) draw: one first `rng.random()`, as `CasiaPairs.get`.

Storage: one .npy per (key, variant) plus label.npy and meta.json, in the
JAX package's NHWC layout and file names (`FEATURE_SHAPES`, `_fname`), so
the two packages' caches compare file by file; the loader's batches go to
NCHW on the card (`to_nchw`). bf16 features are stored as their uint16 bit
patterns and read back through `torch.Tensor.view(torch.bfloat16)`.
meta.json is written last, so a crashed build never looks complete.

Exact only for datasets whose one random augmentation is the paired flip
(CasiaPairs); a SyntheticPairs cache freezes its noise draw.

Several processes over one shared cache_dir (`build_feature_cache_shared`,
ffrnet_tpu/train.py:483-521): process 0 builds; the others watch for the
meta.json of the build they expect and for the build's heartbeat on
its lock (`lock_age_s`), and meet at a barrier after. A barrier alone would
be held through the whole build, longer than a process group's timeout.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import time
from typing import Dict

import numpy as np
import torch

FEATURE_SHAPES = {
    "featmap_non": (7, 7, 512),
    "featmap_ocl": (7, 7, 512),
    "embed_non": (512,),
    "embed_ocl": (512,),
}
_META = "meta.json"
_LOCK = "building.lock"


def _touch_lock(cache_dir: str) -> None:
    path = os.path.join(cache_dir, _LOCK)
    with open(path, "a"):
        os.utime(path, None)


def lock_age_s(cache_dir: str):
    """Seconds since a running build's last heartbeat (it touches the lock
    each batch), or None when no build is in progress."""
    try:
        return time.time() - os.path.getmtime(os.path.join(cache_dir, _LOCK))
    except OSError:
        return None


def _np_dtype(compute_dtype: str):
    return np.float32 if compute_dtype == "fp32" else np.uint16  # bf16 bits


def _fname(key: str, flip: bool) -> str:
    return f"{key}_v{int(flip)}.npy"


def _tensor_bytes(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def cache_fingerprint(dataset, encoder: torch.nn.Module, extra: str = "") -> str:
    """A content hash of (encoder weights, dataset): a cache built for one
    encoder or sample list is never reused for another. It covers every
    state-dict tensor's shape and bytes, the dataset's item identity
    (CasiaPairs items, LFW pair names, else type and length), its absolute
    image root with the sizes of three sampled files (a re-aligned tree
    under a new root with the same list does not reuse stale features; an
    in-place overwrite that keeps every sampled size is not detected), and
    `extra` when it is not empty."""
    h = hashlib.blake2b(digest_size=16)
    for t in encoder.state_dict().values():
        h.update(str(tuple(t.shape)).encode())
        h.update(_tensor_bytes(t))
    ident = (type(dataset).__name__, len(dataset),
             getattr(dataset, "items", None) or getattr(dataset, "pair_names", None) or "")
    h.update(repr(ident).encode())
    root = getattr(dataset, "data_root", None) or getattr(dataset, "face_root", None)
    if root:
        h.update(os.path.abspath(root).encode())
        items = getattr(dataset, "items", None) or []
        for i in sorted({0, len(items) // 2, len(items) - 1} if items else ()):
            entry = items[i]
            rel = entry[0] if isinstance(entry, (tuple, list)) else entry
            try:
                size = os.path.getsize(os.path.join(root, rel))
            except OSError:
                size = -1
            h.update(f"{rel}:{size}".encode())
    if extra:
        h.update(extra.encode())
    return h.hexdigest()


def cache_meta(dataset, encoder: torch.nn.Module, compute_dtype: str,
               fingerprint_extra: str = "") -> dict:
    """The meta.json of a complete cache of `dataset` by `encoder`."""
    return {"n": len(dataset), "compute_dtype": compute_dtype, "version": 2,
            "fingerprint": cache_fingerprint(dataset, encoder, fingerprint_extra)}


def _has_meta(cache_dir: str, meta: dict) -> bool:
    try:
        with open(os.path.join(cache_dir, _META)) as f:
            return json.load(f) == meta
    except (OSError, ValueError):  # absent, or caught while written
        return False


@torch.no_grad()
def build_feature_cache(dataset, encoder: torch.nn.Module, cache_dir: str, *,
                        batch_size: int = 256, compute_dtype: str = "fp32",
                        num_threads: int = 4, encoder_factory=None,
                        fingerprint_extra: str = "") -> str:
    """Encode every sample of a flip-free paired dataset (flip_prob 0: the
    flipped variant is made on the encoder's device) into cache_dir, with
    the fp32 `encoder` run in the compute type. Returns cache_dir.

    encoder_factory: a zero-argument callable giving the encoder the build
    runs instead, already in the compute type (the driver's int8-static
    encoder); it is called only when a build is needed, after the lock
    exists. The fingerprint hashes the float `encoder` and
    `fingerprint_extra`, which names such a variant.

    Idempotent: a complete cache with the same meta (size, compute type,
    fingerprint) is left as it is."""
    from ffrnet_torch.data.pipeline import BatchLoader
    from ffrnet_torch.training.trainer import encode_frozen, half_dtype

    if getattr(dataset, "flip_prob", 0) != 0:
        raise ValueError("build_feature_cache needs a flip-free dataset (flip_prob=0); "
                         "the flip variants are made on the device")
    n = len(dataset)
    meta = cache_meta(dataset, encoder, compute_dtype, fingerprint_extra)
    meta_path = os.path.join(cache_dir, _META)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            if json.load(f) == meta:
                return cache_dir
        # drop the stale meta before truncating the arrays: a crashed rebuild
        # must not pass the check above with partial features
        os.remove(meta_path)
    os.makedirs(cache_dir, exist_ok=True)
    _touch_lock(cache_dir)

    half = half_dtype(compute_dtype)
    if encoder_factory is not None:
        enc = encoder_factory()
    else:
        enc = copy.deepcopy(encoder).to(half).eval() if half is not None else encoder
    dev = encoder.input_layer[0].weight.device

    dt = _np_dtype(compute_dtype)
    mm: Dict[str, np.memmap] = {}
    for key, shape in FEATURE_SHAPES.items():
        for flip in (False, True):
            mm[_fname(key, flip)] = np.lib.format.open_memmap(
                os.path.join(cache_dir, _fname(key, flip)), mode="w+", dtype=dt,
                shape=(n,) + shape)
    labels = np.lib.format.open_memmap(os.path.join(cache_dir, "label.npy"), mode="w+",
                                       dtype=np.int32, shape=(n,))

    loader = BatchLoader(dataset, batch_size, shuffle=False, drop_last=False, seed=0,
                         num_threads=num_threads, device=dev)
    off = 0
    for batch in loader.epoch(0):
        _touch_lock(cache_dir)  # heartbeat
        k = batch["label"].shape[0]
        for flip in (False, True):
            b = {"img_non": batch["img_non"].flip(2) if flip else batch["img_non"],
                 "img_ocl": batch["img_ocl"].flip(2) if flip else batch["img_ocl"],
                 "label": batch["label"]}
            feats = encode_frozen(enc, b)
            for key in FEATURE_SHAPES:
                t = feats[key]
                if t.ndim == 4:
                    t = t.permute(0, 2, 3, 1)  # NCHW -> the NHWC layout on disk
                t = t.contiguous().cpu()
                arr = t.view(torch.int16).numpy().view(np.uint16) if half is not None \
                    else t.numpy()
                mm[_fname(key, flip)][off:off + k] = arr
        labels[off:off + k] = batch["label"].cpu().numpy()
        off += k
    if off != n:
        raise RuntimeError(f"feature cache: encoded {off} samples of {n}")
    for m in mm.values():
        m.flush()
    labels.flush()
    with open(meta_path, "w") as f:  # last: only a finished build looks complete
        json.dump(meta, f)
    try:
        os.remove(os.path.join(cache_dir, _LOCK))
    except OSError:
        pass
    return cache_dir


def build_feature_cache_shared(dataset, encoder: torch.nn.Module, cache_dir: str, *,
                               process_index: int, group=None, poll_s: float = 2.0,
                               **build_kw) -> str:
    """`build_feature_cache` by one of several processes over a shared
    cache_dir. Process 0 builds. Another waits until the meta.json of the
    cache it expects appears; if neither that meta nor a live lock has
    appeared after FFRNET_CACHE_GRACE_S seconds (default 300), cache_dir is
    local to its host and it builds there itself; a lock whose heartbeat
    is older than FFRNET_CACHE_STALE_S (default 1800) raises. Then every
    process meets at a barrier of `group` (a group for host collectives)."""
    import torch.distributed as dist

    if process_index == 0:
        build_feature_cache(dataset, encoder, cache_dir, **build_kw)
    else:
        want = cache_meta(dataset, encoder, build_kw.get("compute_dtype", "fp32"),
                          build_kw.get("fingerprint_extra", ""))
        grace = time.time() + float(os.environ.get("FFRNET_CACHE_GRACE_S", "300"))
        stale_s = float(os.environ.get("FFRNET_CACHE_STALE_S", "1800"))
        while not _has_meta(cache_dir, want):
            age = lock_age_s(cache_dir)
            if age is None and time.time() > grace:  # no meta, no lock: a host-local dir
                build_feature_cache(dataset, encoder, cache_dir, **build_kw)
                break
            if age is not None and age > stale_s:
                raise RuntimeError(
                    f"feature-cache build heartbeat in {cache_dir} is {age:.0f}s stale — the "
                    "building process likely crashed; remove building.lock (and any partial .npy "
                    "files) and restart")
            time.sleep(poll_s)
    if dist.is_initialized():
        dist.barrier(group=group)
    return cache_dir


class CachedFeatureDataset:
    """Cached frozen-encoder features with the paired-flip draw.

    get(idx, rng) -> {featmap_non, featmap_ocl, embed_non, embed_ocl,
    label} of the variant rng's first draw picks (numpy float32 for an fp32
    cache; torch bf16 tensors for a bf16 one), NHWC maps."""

    def __init__(self, cache_dir: str, flip_prob: float = 0.5):
        with open(os.path.join(cache_dir, _META)) as f:
            self.meta = json.load(f)
        self.flip_prob = flip_prob
        self._arrays = {name: np.load(os.path.join(cache_dir, name), mmap_mode="r")
                        for name in [_fname(k, fl) for k in FEATURE_SHAPES
                                     for fl in (False, True)]}
        self._labels = np.load(os.path.join(cache_dir, "label.npy"), mmap_mode="r")
        self._bf16 = self.meta["compute_dtype"] == "bf16"

    def __len__(self):
        return int(self.meta["n"])

    def _read(self, key: str, flip: bool, idx: int):
        arr = np.array(self._arrays[_fname(key, flip)][idx])  # a copy out of the map
        if self._bf16:
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return arr

    def get(self, idx: int, rng: np.random.Generator):
        flip = rng.random() < self.flip_prob  # the paired flip, one draw
        out = {key: self._read(key, flip, idx) for key in FEATURE_SHAPES}
        out["label"] = np.int32(self._labels[idx])
        return out


def to_nchw(batch):
    """A loader batch of cached features with its NHWC maps ('featmap_*',
    or packed 'featmaps' (N, 2, 7, 7, 512)) as contiguous NCHW, the port's
    layout, on the batch's device."""
    return {k: (v.movedim(-1, -3).contiguous() if k.startswith("featmap") else v)
            for k, v in batch.items()}
