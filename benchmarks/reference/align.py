"""Plain face alignment: MATLAB cp2tform 'similarity' (the reflective fit,
lfw/matlab_cp2tform.py of the FFR-Net reference) and cv2.warpAffine's
bilinear warp with a zero border, in float64.

The nonreflective fit is a least-squares solve of the stacked system
[x y 1 0; y -x 0 1] r = [u; v] for r = (sc, ss, tx, ty), the dst -> src map;
the reflective fit solves against x-mirrored dst points and mirrors the
result back; the fit with the lower residual wins (a tie keeps the
nonreflective one).
"""

from __future__ import annotations

import numpy as np
import torch

# ArcFace's five reference points of the 96x112 crop (lfw/gen_lfw112x96.py),
# and of the 112x112 crop (shifted +8 in x)
ARCFACE_REF_PTS = np.array(
    [[30.2946, 51.6963], [65.5318, 51.5014], [48.0252, 71.7366],
     [33.5493, 92.3655], [62.7299, 92.2041]], dtype=np.float32)
REF_PTS_112 = ARCFACE_REF_PTS + np.asarray([8.0, 0.0], np.float32)


def _nonreflective(uv, xy):
    """(N, 3, 3) T with [x y 1] = [u v 1] T, from least squares of the
    dst -> src system; uv, xy (N, K, 2) float64."""
    n, k, _ = uv.shape
    x, y = xy[..., 0], xy[..., 1]
    one, zero = np.ones_like(x), np.zeros_like(x)
    a = np.concatenate([np.stack([x, y, one, zero], -1),
                        np.stack([y, -x, zero, one], -1)], axis=1)        # (N, 2K, 4)
    b = np.concatenate([uv[..., 0], uv[..., 1]], axis=1)                  # (N, 2K)
    r = np.stack([np.linalg.lstsq(a[i], b[i], rcond=None)[0] for i in range(n)])
    sc, ss, tx, ty = r.T
    tinv = np.zeros((n, 3, 3))
    tinv[:, 0, 0], tinv[:, 0, 1] = sc, -ss
    tinv[:, 1, 0], tinv[:, 1, 1] = ss, sc
    tinv[:, 2, 0], tinv[:, 2, 1], tinv[:, 2, 2] = tx, ty, 1.0
    return np.linalg.inv(tinv)


def _residual(t, uv, xy):
    fwd = np.concatenate([uv, np.ones(uv.shape[:-1] + (1,))], -1) @ t
    return np.sqrt(((fwd[..., :2] - xy) ** 2).sum(axis=(1, 2)))


def cv2_matrices(landmarks, ref_pts=REF_PTS_112):
    """(N, 2, 3) float64 src -> dst matrices in cv2's column convention,
    [x y]^T = M [u v 1]^T, for (N, 5, 2) source landmarks."""
    uv = np.asarray(landmarks, np.float64)
    xy = np.broadcast_to(np.asarray(ref_pts, np.float64), uv.shape)
    t1 = _nonreflective(uv, xy)
    t2 = _nonreflective(uv, xy * np.asarray([-1.0, 1.0])) @ np.diag([-1.0, 1.0, 1.0])
    keep1 = _residual(t1, uv, xy) <= _residual(t2, uv, xy)
    t = np.where(keep1[:, None, None], t1, t2)
    return np.transpose(t[:, :, :2], (0, 2, 1))


def inverse(mats):
    """(N, 2, 3) cv2 matrices -> their dst -> src inverses, float64."""
    full = np.concatenate([mats, np.tile([[[0.0, 0.0, 1.0]]], (mats.shape[0], 1, 1))], 1)
    return np.linalg.inv(full)[:, :2, :]


def warp(imgs, mats_inv, out_hw=(112, 112)):
    """Bilinear warp of (N, H, W, C) images by (N, 2, 3) dst -> src
    matrices, zero outside the source: float64 on the images' device."""
    n, h, w, c = imgs.shape
    dev = imgs.device
    m = torch.as_tensor(mats_inv, dtype=torch.float64, device=dev)
    ys, xs = torch.meshgrid(torch.arange(out_hw[0], dtype=torch.float64, device=dev),
                            torch.arange(out_hw[1], dtype=torch.float64, device=dev),
                            indexing="ij")
    xs, ys = xs.reshape(1, -1), ys.reshape(1, -1)
    sx = m[:, 0, 0, None] * xs + m[:, 0, 1, None] * ys + m[:, 0, 2, None]
    sy = m[:, 1, 0, None] * xs + m[:, 1, 1, None] * ys + m[:, 1, 2, None]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    flat = imgs.reshape(n, h * w, c).to(torch.float64)
    out = torch.zeros((n, xs.shape[1], c), dtype=torch.float64, device=dev)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            tx, ty = (x0 + dx).long(), (y0 + dy).long()
            ok = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
            idx = (ty.clamp(0, h - 1) * w + tx.clamp(0, w - 1))
            vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
            out += (wx * wy * ok)[..., None] * vals
    return out.reshape(n, out_hw[0], out_hw[1], c)
