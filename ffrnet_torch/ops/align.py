"""Batched face alignment: cp2tform similarity solve + affine warp.

Counterpart of ffrnet_tpu/ops/align.py. The reference aligns one face at a
time on the host: a NumPy port of MATLAB cp2tform solves a 4-unknown least
squares system per face (lfw/matlab_cp2tform.py:223-432) and cv2.warpAffine
crops it (lfw/gen_lfw112x96.py:6-17). Here:

  * `similarity_transform` solves the nonreflective system from its 4x4
    normal equations in float64 numpy on the host (their entries reach ~4e4
    beside ~5, and an fp32 solve is 2.7e-4 relative off in the rotation
    term), evaluates the Y-reflected fit too and keeps the lower-residual
    one per face (<= prefers the nonreflective fit,
    lfw/matlab_cp2tform.py:425-430). The matrices leave it as float32.
  * `align_faces` warps on the images' device through the two warp kernels
    (ops/kernels/warp.py): the band kernel where the host-side bound guard
    (`auto_band_crop_w`, read off the same solve) proves a window exact,
    else the full kernel; `warp_affine` is the plain gather reference.

ARCFACE_REF_PTS are the canonical 5-point destination landmarks of the
96x112 crop (lfw/gen_lfw112x96.py:8-9).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ffrnet_torch.ops.kernels.warp import (_invert_2x3, _src_coords, warp_affine_band,
                                           warp_affine_full)

# Canonical ArcFace reference landmarks for a (W=96, H=112) crop.
ARCFACE_REF_PTS = np.array(
    [[30.2946, 51.6963], [65.5318, 51.5014], [48.0252, 71.7366],
     [33.5493, 92.3655], [62.7299, 92.2041]], dtype=np.float32)

IMPLS = ("auto", "gather")
# residuals this close count as a tie, where the guard takes the max over
# both fits (the JAX package's margins, which cover its fp32 selection)
_TIE_REL, _TIE_ABS = 1e-3, 1e-2
# warp_affine_band's band width
_BAND_W = 16


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _solve_nonreflective(uv, xy):
    """Closed-form nonreflective similarity fit, batched, float64 numpy.

    Solves for r = (sc, ss, tx, ty) minimizing ||X r - U||^2 where X is the
    stacked [x y 1 0; y -x 0 1] system (lfw/matlab_cp2tform.py:297-312):
    r holds the xy -> uv coefficients. uv, xy: (..., K, 2); returns (..., 4).
    """
    x, y = xy[..., 0], xy[..., 1]
    u, v = uv[..., 0], uv[..., 1]
    k = x.shape[-1]
    sxx = (x * x + y * y).sum(-1)
    sx, sy = x.sum(-1), y.sum(-1)
    zero, kk = np.zeros_like(sx), np.full_like(sx, float(k))
    xtx = np.stack([
        np.stack([sxx, zero, sx, sy], axis=-1),
        np.stack([zero, sxx, sy, -sx], axis=-1),
        np.stack([sx, sy, kk, zero], axis=-1),
        np.stack([sy, -sx, zero, kk], axis=-1),
    ], axis=-2)
    xtu = np.stack([(x * u + y * v).sum(-1), (y * u - x * v).sum(-1),
                    u.sum(-1), v.sum(-1)], axis=-1)
    return np.linalg.solve(xtx, xtu[..., None])[..., 0]


def _trans(r):
    """The 3x3 trans mapping uv -> xy row vectors ([x, y, 1] = [u, v, 1] @
    trans) of a fit r: inv(Tinv) with last column [0, 0, 1]
    (lfw/matlab_cp2tform.py:320-335), the 2x2 + translation directly."""
    sc, ss, tx, ty = (r[..., i] for i in range(4))
    det = sc * sc + ss * ss
    l00, l01 = sc / det, ss / det
    l10, l11 = -ss / det, sc / det
    t0 = -(tx * l00 + ty * l10)
    t1 = -(tx * l01 + ty * l11)
    zero, one = np.zeros_like(sc), np.ones_like(sc)
    return np.stack([
        np.stack([l00, l01, zero], axis=-1),
        np.stack([l10, l11, zero], axis=-1),
        np.stack([t0, t1, one], axis=-1),
    ], axis=-2)


def _tformfwd(trans, uv):
    """Apply a row-vector transform, elementwise: (..., K, 2) with
    (..., 3, 3) -> (..., K, 2)."""
    u, v = uv[..., 0], uv[..., 1]

    def col(j):
        return u * trans[..., 0, j, None] + v * trans[..., 1, j, None] + trans[..., 2, j, None]

    return np.stack([col(0), col(1)], axis=-1)


def _fit(src, dst, reflected: bool):
    """One cp2tform fit of src -> dst, float64: (r, trans, residual). The
    reflected fit solves against Y-mirrored dst and mirrors trans back
    (trans @ diag(-1, 1, 1))."""
    r = _solve_nonreflective(src, dst * np.asarray([-1.0, 1.0]) if reflected else dst)
    trans = _trans(r)
    if reflected:
        trans = np.concatenate([-trans[..., :1], trans[..., 1:]], axis=-1)
    d = _tformfwd(trans, src) - dst
    return r, trans, np.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]).sum(-1))


def _select(src_pts, dst_pts):
    """Reflective cp2tform, float64, and what the band guard reads of it.

    Returns (trans, |sc|, |ss|): trans of the lower-residual fit (<= prefers
    the nonreflective one, lfw/matlab_cp2tform.py:425-430), and the
    dst -> src linear coefficients of that fit, or their max over both
    fits at a tie."""
    src, dst = _np64(src_pts), _np64(dst_pts)
    r1, trans1, n1 = _fit(src, dst, reflected=False)
    r2, trans2, n2 = _fit(src, dst, reflected=True)
    pick1 = n1 <= n2
    tie = np.abs(n1 - n2) <= _TIE_ABS + _TIE_REL * np.maximum(n1, n2)
    sc1, ss1 = np.abs(r1[..., 0]), np.abs(r1[..., 1])
    sc2, ss2 = np.abs(r2[..., 0]), np.abs(r2[..., 1])
    sc = np.where(tie, np.maximum(sc1, sc2), np.where(pick1, sc1, sc2))
    ss = np.where(tie, np.maximum(ss1, ss2), np.where(pick1, ss1, ss2))
    return np.where(pick1[..., None, None], trans1, trans2), sc, ss


def similarity_transform(src_pts, dst_pts):
    """Batched cp2tform: the float32 3x3 trans mapping src -> dst (row
    vectors), on the host. src_pts, dst_pts: (..., K, 2) arrays or tensors.
    The Y-reflected fit is evaluated too and the lower-residual one
    returned (ties keep the nonreflective fit)."""
    return torch.from_numpy(_select(src_pts, dst_pts)[0].astype(np.float32))


def _cv2(trans):
    """(..., 3, 3) row-vector trans -> (..., 2, 3) cv2 matrices."""
    return trans[..., :, 0:2].transpose(-1, -2)


def cv2_transform(src_pts, dst_pts):
    """(..., 2, 3) float32 matrices in the column-vector convention
    [x, y]^T = M @ [u, v, 1]^T (get_similarity_transform_for_cv2,
    lfw/matlab_cp2tform.py:503-537), on the host."""
    return _cv2(similarity_transform(src_pts, dst_pts))


def warp_affine(imgs, mats, *, out_hw: Tuple[int, int]):
    """Batched cv2.warpAffine-equivalent bilinear warp, zero border: the
    plain gather reference of the warp kernels.

    imgs: (N, H, W, C); mats: (N, 2, 3) forward (src -> dst) matrices in the
    cv2 column-vector convention, inverted here as cv2 does. Integer images
    are computed in (and returned as) float32: weights cast to uint8 would
    truncate to 0.
    """
    if not imgs.dtype.is_floating_point:
        imgs = imgs.float()
    n, h, w, c = imgs.shape
    out_h, out_w = out_hw
    inv = _invert_2x3(mats.to(imgs.device, torch.float32))
    ys, xs = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=imgs.device),
                            torch.arange(out_w, dtype=torch.float32, device=imgs.device),
                            indexing="ij")
    sx, sy = _src_coords(inv, xs.reshape(-1), ys.reshape(-1))  # (N, P) each
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0i, y0i = x0.long(), y0.long()
    flat = imgs.reshape(n, h * w, c)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return vals * valid[..., None].to(imgs.dtype)

    v00, v01 = gather(y0i, x0i), gather(y0i, x0i + 1)
    v10, v11 = gather(y0i + 1, x0i), gather(y0i + 1, x0i + 1)
    w00 = ((1 - fy) * (1 - fx))[..., None].to(imgs.dtype)
    w01 = ((1 - fy) * fx)[..., None].to(imgs.dtype)
    w10 = (fy * (1 - fx))[..., None].to(imgs.dtype)
    w11 = (fy * fx)[..., None].to(imgs.dtype)
    out = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11
    return out.reshape(n, out_h, out_w, c)


# ------------------------------------------------------- host-side guards


def _selected_inv_abs_np(src_pts, dst_pts):
    """(|sc|, |ss|) of the dst -> src linear map of the fit
    `similarity_transform` selects (max over both fits at a tie)."""
    return _select(src_pts, dst_pts)[1:]


def _band_crop_w(sc, ss, src_hw, out_h):
    h, w = src_hw
    wp = max(w + (-w % 32), 64)
    need = float((sc * (_BAND_W - 1) + ss * (out_h - 1)).max()) + 3 + 32
    cw = max(-int(-need // 32) * 32, 64)
    return cw if cw <= wp else None


def auto_band_crop_w(landmarks, ref_pts, src_hw: Tuple[int, int], out_h: int):
    """Smallest exact crop_w for warp_affine_band at its default band_w, on
    the host.

    Bound: |sc|*(band_w-1) + |ss|*(out_h-1) + 3 taps + 32 window-quantization
    slack, rounded up to a multiple of 32. None when it exceeds the padded
    source width (extreme scale or rotation: use the full warp).
    """
    sc, ss = _selected_inv_abs_np(landmarks, ref_pts)
    return _band_crop_w(sc, ss, src_hw, out_h)


# --------------------------------------------------------------- alignment


def align_faces(imgs, landmarks, *, out_hw: Tuple[int, int] = (112, 96), ref_pts=None,
                impl: str = "auto"):
    """Batched alignment: landmarks -> cp2tform -> warp, on imgs' device.

    imgs: (N, H, W, C) tensor, uint8 (cast to float32 on its device) or
    float; landmarks: (N, 5, 2) (x, y) points, array or tensor. Returns
    (N, out_h, out_w, C) crops, float (the on-device equivalent of
    gen_lfw112x96.align, lfw/gen_lfw112x96.py:6-17).

    impl:
      'auto'   -- the band kernel with the smallest crop_w that
                  `auto_band_crop_w` proves exact, or the full kernel in
                  fp32 where no crop_w is (extreme transforms)
      'gather' -- the plain gather reference `warp_affine`

    One float64 solve on the host gives both the matrices, copied to the
    device as float32, and the guard's bound.
    """
    if impl not in IMPLS:
        raise ValueError(f"align_faces: impl must be one of {IMPLS}, got {impl!r} (the JAX "
                         f"package's 'tiled', 'mxu' and 'pallas_band' are not ported)")
    lmk = np.asarray(landmarks.detach().cpu() if isinstance(landmarks, torch.Tensor)
                     else landmarks, np.float32)
    ref = np.asarray(ARCFACE_REF_PTS if ref_pts is None else ref_pts, np.float32)
    trans, sc, ss = _select(lmk, ref)
    mats = _cv2(torch.from_numpy(trans.astype(np.float32))).to(imgs.device)
    if not imgs.dtype.is_floating_point:
        imgs = imgs.float()
    if impl == "gather":
        return warp_affine(imgs, mats, out_hw=out_hw)
    cw = _band_crop_w(sc, ss, tuple(imgs.shape[1:3]), out_hw[0])
    if cw is None:
        return warp_affine_full(imgs, mats, out_hw=out_hw, compute_dtype=torch.float32)
    return warp_affine_band(imgs, mats, out_hw=out_hw, crop_w=cw)
