"""Attention-map visualization (reference lfw/lfw_eval.py:164-223); a copy
of ffrnet_tpu/eval/visualize.py (numpy only).

Renders, for a clean/masked image pair batch:
  column 1: the input image
  column 2: the 67x67 spatial-attention grid — M_space reshaped to
            (7, 7, 7, 7) and tiled with 3-px gutters (67 = 10*6 + 7)
  column 3: the (512, 512) channel-attention matrix
  column 4: the mean feature map over the argmax-selected channels

All inputs are numpy arrays in NHWC / (N, p, q) layout; output is one uint8 image
grid suitable for Logger.record_single_image.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ffrnet_torch.utils.image import batch_numpy_to_image, normalization

_IMAGENET_BGR_MEAN = (131.0912, 103.8827, 91.4953)  # lfw_eval.py:197


def _space_grid(m_space: np.ndarray) -> np.ndarray:
    """(N, 49, 49) -> (N, 67, 67) tiled attention grid."""
    n = m_space.shape[0]
    maps = m_space.reshape(n, 7, 7, 7, 7)  # (N, p_h, p_w, q_h, q_w)
    grid = np.full((n, 67, 67), maps.max())
    for i in range(7):
        for j in range(7):
            grid[:, i * 10:i * 10 + 7, j * 10:j * 10 + 7] = maps[..., i, j]
    return normalization(grid) * 255


def _channel_selected_map(featmap_nhwc: np.ndarray,
                          m_channel: np.ndarray) -> np.ndarray:
    """Mean over argmax-selected channels (lfw_eval.py:179-189)."""
    sel = np.argmax(m_channel, axis=2)  # (N, 512)
    n, h, w, c = featmap_nhwc.shape
    fm = featmap_nhwc.transpose(0, 3, 1, 2)  # (N, C, H, W)
    gathered = np.take_along_axis(fm, sel[:, :, None, None].repeat(h, 2)
                                  .repeat(w, 3), axis=1)
    return normalization(gathered.mean(axis=1)) * 255


def attention_panel(images_nhwc, m_space, m_channel, featmap_nhwc,
                    n_rows: int = 8) -> np.ndarray:
    """One branch's 4-column panel: image | M_space grid | M_channel | map."""
    n = min(n_rows, images_nhwc.shape[0])
    imgs = np.asarray(images_nhwc[:n]).transpose(0, 3, 1, 2)
    imgs = (imgs + 1.0) * 127.5  # [-1, 1] -> [0, 255]
    cols = [
        batch_numpy_to_image(imgs),
        batch_numpy_to_image(_space_grid(np.asarray(m_space[:n]))[:, None],
                             size=(112, 112)),
        batch_numpy_to_image(
            (normalization(np.asarray(m_channel[:n])) * 255)[:, None],
            size=(112, 112)),
        batch_numpy_to_image(
            _channel_selected_map(np.asarray(featmap_nhwc[:n]),
                                  np.asarray(m_channel[:n]))[:, None],
            size=(112, 112)),
    ]
    rows = [np.hstack([col[i] for col in cols]) for i in range(n)]
    return np.vstack(rows).astype(np.uint8)


def visualize_pair(nonocl_imgs, out_non, ocl_imgs, out_ocl, featmap_non,
                   featmap_ocl, n_rows: int = 8) -> np.ndarray:
    """Clean + masked panels side by side (reference layout, 8 columns)."""
    left = attention_panel(nonocl_imgs, out_non.m_space, out_non.m_channel,
                           featmap_non, n_rows)
    right = attention_panel(ocl_imgs, out_ocl.m_space, out_ocl.m_channel,
                            featmap_ocl, n_rows)
    return np.hstack([left, right])
