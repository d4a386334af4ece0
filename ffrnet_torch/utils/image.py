"""Image helpers (capability parity with reference utils/utils.py:9-80); a
copy of ffrnet_tpu/utils/image.py.

numpy-only (no cv2/imageio dependency on the hot path): tensor<->image
conversion, batch grid assembly with nearest resize, per-map min-max
normalization (reference `normalization`, models/trainer.py:46-50).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def normalization(maps: np.ndarray) -> np.ndarray:
    """Per-map min-max normalize over the trailing two axes
    (models/trainer.py:46-50)."""
    mx = maps.max(axis=(-2, -1), keepdims=True)
    mn = maps.min(axis=(-2, -1), keepdims=True)
    rng = np.where(mx - mn == 0, 1.0, mx - mn)
    return (maps - mn) / rng


def _resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) nearest resize to (W_out, H_out) — cv2.resize arg order."""
    w_out, h_out = size
    h, w = img.shape[:2]
    ys = (np.arange(h_out) * h / h_out).astype(np.int64).clip(0, h - 1)
    xs = (np.arange(w_out) * w / w_out).astype(np.int64).clip(0, w - 1)
    return img[ys][:, xs]


def batch_numpy_to_image(array: np.ndarray, size=None,
                         v_range=(0, 255)) -> np.ndarray:
    """(B, C, H, W) float array -> (B, H', W', 3) uint8-ranged images
    (reference utils/utils.py:25-46)."""
    if isinstance(size, int):
        size = (size, size)
    if array.shape[1] == 1:
        array = np.repeat(array, 3, 1)
    array = np.clip((array - v_range[0]) / (v_range[1] - v_range[0]) * 255,
                    0, 255)
    array = np.transpose(array, (0, 2, 3, 1))
    if size is not None:
        array = np.stack([_resize_nearest(a, size) for a in array])
    return array


def to_uint8_grid(rows: Sequence[Sequence[np.ndarray]]) -> np.ndarray:
    """Stack images row-wise then column-wise into one uint8 grid."""
    return np.vstack([np.hstack(list(r)) for r in rows]).astype(np.uint8)


def img_to_array(img_path: str, size=None, mode: str = "rgb") -> np.ndarray:
    """Read an image into an NHWC float32 [-1, 1] batch-of-one
    (reference img_to_tensor, utils/utils.py:9-21; PIL instead of imageio)."""
    from PIL import Image

    img = Image.open(img_path).convert("RGB")
    if size is not None:
        img = img.resize(size, Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32)
    if mode == "bgr":
        arr = arr[..., ::-1]
    return (arr / 255.0 * 2.0 - 1.0)[None]


def select_yx(featmap: np.ndarray, y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Gather per-(batch, channel) spatial locations from an NHWC feature map
    (reference select_yx, utils/utils.py:59-75, which was NCHW).

    featmap: (B, H, W, C); y, x: (B, C) integer coords -> (B, C)."""
    b, h, w, c = featmap.shape
    y = np.clip(y, 0, h - 1).astype(np.int64)
    x = np.clip(x, 0, w - 1).astype(np.int64)
    bi = np.arange(b)[:, None]
    ci = np.arange(c)[None, :]
    return featmap[bi, y, x, ci]
