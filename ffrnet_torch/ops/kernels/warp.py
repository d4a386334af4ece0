"""Bilinear affine warps: CUDA kernels (csrc/warp.cu) and plain twins.

Replaces the two kernels of ffrnet_tpu/ops/pallas/warp.py:
  warp_affine_full  <- warp_affine_pallas       (unconditional)
  warp_affine_band  <- warp_affine_pallas_band  (column bands, bounded window)

Both take forward (src -> dst) 2x3 matrices in the cv2 column-vector
convention, invert them in fp32 (`_invert_2x3`; the kernels invert inside,
with the same rounding, so a call is one launch) and sample each output
pixel at the dst -> src coordinate: 2x2 bilinear taps with tent weights
max(1 - |tap - coord|, 0), zero outside the source (cv2's constant-zero
border). Images are NHWC float32 or bfloat16; the output has the image's
type. On the GPU a bilinear warp is a 4-tap gather, so neither kernel
carries the TPU kernels' matmul formulation over (see the source note for
the bound and the design).

Numerics shared by kernel and twin, which therefore agree to the bit:
coordinates are i00*x + i01*y + i02 with every product and sum rounded
(no fused multiply-add), each tap row is wy0*p(y0) + wy1*p(y1), and the
output wx0*t(x0) + wx1*t(x1).
"""

from __future__ import annotations

import torch

from ffrnet_torch.ops.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
# the band kernel's window start is quantized to this many columns
_QUANT = 32
# floor(min sx) is clamped to +-this before the int cast
_COORD_CLAMP = 1e9


def _invert_2x3(m):
    """Invert (N, 2, 3) affine matrices (dst -> src for sampling), fp32.
    Every division is by a tensor, which is IEEE division on the card too."""
    a00, a01, a02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    a10, a11, a12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    det = a00 * a11 - a01 * a10
    i00, i01 = a11 / det, -a01 / det
    i10, i11 = -a10 / det, a00 / det
    t0 = -(i00 * a02 + i01 * a12)
    t1 = -(i10 * a02 + i11 * a12)
    return torch.stack([torch.stack([i00, i01, t0], dim=-1),
                        torch.stack([i10, i11, t1], dim=-1)], dim=-2)


def _src_coords(inv, xs, ys):
    """dst -> src pixel coordinates, elementwise (never a matmul).
    inv (N, 2, 3); xs, ys any shape. Returns (sx, sy) of (N, *xs.shape)."""
    expand = (slice(None),) + (None,) * xs.dim()

    def row(r):
        return inv[:, r, 0][expand] * xs + inv[:, r, 1][expand] * ys + inv[:, r, 2][expand]

    return row(0), row(1)


def _check(name, imgs, mats):
    if imgs.dim() != 4 or imgs.dtype not in _DTYPES:
        raise TypeError(f"{name}: images must be (N, H, W, C) float32 or bfloat16, got "
                        f"{tuple(imgs.shape)} {imgs.dtype}")
    if tuple(mats.shape) != (imgs.shape[0], 2, 3):
        raise ValueError(f"{name}: mats must be ({imgs.shape[0]}, 2, 3), got "
                         f"{tuple(mats.shape)}")


def _tent(tap, coord):
    return torch.clamp_min(1.0 - (tap - coord).abs(), 0.0)


def _bilinear(imgs, sx, sy, xlo, xhi, round_bf16):
    """Plain 4-tap sampling of NHWC `imgs` at (sx, sy), both (N, P): taps
    outside rows [0, H) or columns [xlo, xhi) read zero; a coordinate
    outside (-1, W) x (-1, H) gives zero. Returns (N, P, C) fp32."""
    n, h, w, c = imgs.shape
    inside = (sx > -1) & (sx < w) & (sy > -1) & (sy < h)
    sx = torch.where(inside, sx, 0.0)
    sy = torch.where(inside, sy, 0.0)
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    x0, y0 = x0f.long(), y0f.long()
    wx0, wx1 = _tent(x0f, sx), _tent(x0f + 1, sx)
    wy0, wy1 = _tent(y0f, sy), _tent(y0f + 1, sy)
    pix = imgs
    if round_bf16:
        wy0, wy1 = wy0.bfloat16().float(), wy1.bfloat16().float()
        pix = pix.bfloat16()
    flat = pix.float().reshape(n, h * w, c)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= xlo) & (xi < xhi)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return torch.where(valid[..., None], vals, 0.0)

    t0 = wy0[..., None] * tap(y0, x0) + wy1[..., None] * tap(y0 + 1, x0)
    t1 = wy0[..., None] * tap(y0, x0 + 1) + wy1[..., None] * tap(y0 + 1, x0 + 1)
    out = wx0[..., None] * t0 + wx1[..., None] * t1
    return torch.where(inside[..., None], out, 0.0)


def _grid(out_h, width, device):
    ys, xs = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=device),
                            torch.arange(width, dtype=torch.float32, device=device),
                            indexing="ij")
    return xs, ys


# ----------------------------------------------------------------- full warp


def warp_affine_full_plain(imgs, mats, *, out_hw, compute_dtype=torch.bfloat16):
    """Plain twin of `warp_affine_full`."""
    _check("warp_affine_full", imgs, mats)
    n, h, w, c = imgs.shape
    out_h, out_w = out_hw
    inv = _invert_2x3(mats.float())
    xs, ys = _grid(out_h, out_w, imgs.device)
    sx, sy = _src_coords(inv, xs.reshape(-1), ys.reshape(-1))
    out = _bilinear(imgs, sx, sy, 0, w, compute_dtype == torch.bfloat16)
    return out.reshape(n, out_h, out_w, c).to(imgs.dtype)


def warp_affine_full(imgs, mats, *, out_hw, compute_dtype=torch.bfloat16):
    """Batched cv2-convention affine warp, (N, H, W, C) -> (N, *out_hw, C),
    valid for every transform. `compute_dtype` bfloat16 rounds the
    y-weights and the pixels to bf16 before the products, as the Pallas
    kernel's MXU operands were; float32 keeps everything fp32. The Pallas
    kernel's `block` (a TPU tiling knob) has no counterpart here.

    The plain twin on a CPU tensor; the kernel on a CUDA tensor."""
    if imgs.device.type == "cpu":
        return warp_affine_full_plain(imgs, mats, out_hw=out_hw, compute_dtype=compute_dtype)
    if imgs.device.type != "cuda":
        raise ValueError(f"warp_affine_full: unsupported device {imgs.device}")
    _check("warp_affine_full", imgs, mats)
    if compute_dtype not in _DTYPES:
        raise TypeError(f"warp_affine_full: compute_dtype must be float32 or bfloat16, "
                        f"got {compute_dtype}")
    n, h, w, c = imgs.shape
    out_h, out_w = out_hw
    imgs = imgs.contiguous()
    m = mats.to(imgs.device, torch.float32).reshape(n, 6).contiguous()
    out = torch.empty((n, out_h, out_w, c), device=imgs.device, dtype=imgs.dtype)
    fn = _build.load("warp", "warp_full_launch", 3, 8)
    rc = fn(imgs.data_ptr(), m.data_ptr(), out.data_ptr(), n, h, w, c, out_h, out_w,
            int(imgs.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16),
            _build.stream_handle(imgs.device))
    _build.check_launch("warp_affine_full", rc)
    warp_affine_full.launches += 1
    return out


warp_affine_full.launches = 0


# ----------------------------------------------------------------- band warp


def _band_geometry(w, out_w, band_w, crop_w):
    """(padded source width, number of bands) of the band kernel. The
    Pallas kernel also padded the height, to 8 rows of zeros: rows at or
    past H read zero here."""
    return max(w + (-w % _QUANT), crop_w), -(-out_w // band_w)


def _check_band(imgs, band_w, crop_w):
    if crop_w % _QUANT:
        raise ValueError(f"warp_affine_band: crop_w must be a multiple of {_QUANT}, "
                         f"got {crop_w}")
    if imgs.shape[-1] > 4:
        raise ValueError(f"warp_affine_band: at most 4 channels, got {imgs.shape[-1]}")
    if band_w < 1:
        raise ValueError(f"warp_affine_band: band_w must be positive, got {band_w}")


def warp_affine_band_plain(imgs, mats, *, out_hw, band_w=16, crop_w=64):
    """Plain twin of `warp_affine_band`."""
    _check("warp_affine_band", imgs, mats)
    _check_band(imgs, band_w, crop_w)
    n, h, w, c = imgs.shape
    out_h, out_w = out_hw
    wp, nb = _band_geometry(w, out_w, band_w, crop_w)
    inv = _invert_2x3(mats.float())
    xs, ys = _grid(out_h, nb * band_w, imgs.device)
    sx, sy = _src_coords(inv, xs, ys)  # (N, out_h, nb * band_w)
    # window start per (image, band): min over every pixel of the band,
    # the columns past out_w in the last band included
    smin = sx.reshape(n, out_h, nb, band_w).amin(dim=(1, 3))
    x0 = torch.floor(smin).clamp(-_COORD_CLAMP, _COORD_CLAMP).long() - 1
    x0 = (x0.clamp_min(0) // _QUANT * _QUANT).clamp_max(wp - crop_w)  # (N, nb)
    xlo = x0.repeat_interleave(band_w, dim=1)[:, None, :out_w].expand(n, out_h, out_w)
    xhi = torch.clamp_max(xlo + crop_w, w)
    sx, sy = sx[..., :out_w], sy[..., :out_w]
    out = _bilinear(imgs, sx.reshape(n, -1), sy.reshape(n, -1), xlo.reshape(n, -1),
                    xhi.reshape(n, -1), imgs.dtype == torch.bfloat16)
    return out.reshape(n, out_h, out_w, c).to(imgs.dtype)


def warp_affine_band(imgs, mats, *, out_hw, band_w=16, crop_w=64):
    """Column-band affine warp, (N, H, W, C<=4) -> (N, *out_hw, C): each band
    of `band_w` output columns reads only a `crop_w`-wide source window that
    starts at floor(min sx) - 1, quantized down to 32 columns. Exact under
    the contract |sc|(band_w-1) + |ss|(out_h-1) + 35 <= crop_w, with
    (sc, ss) the dst -> src linear coefficients (`ops.align.auto_band_crop_w`
    picks crop_w); outside it, it computes what the Pallas kernel computes.
    bfloat16 images round the y-weights to bf16, as the Pallas kernel did.

    The plain twin on a CPU tensor; the kernel on a CUDA tensor."""
    if imgs.device.type == "cpu":
        return warp_affine_band_plain(imgs, mats, out_hw=out_hw, band_w=band_w,
                                      crop_w=crop_w)
    if imgs.device.type != "cuda":
        raise ValueError(f"warp_affine_band: unsupported device {imgs.device}")
    _check("warp_affine_band", imgs, mats)
    _check_band(imgs, band_w, crop_w)
    n, h, w, c = imgs.shape
    out_h, out_w = out_hw
    wp, _ = _band_geometry(w, out_w, band_w, crop_w)
    imgs = imgs.contiguous()
    m = mats.to(imgs.device, torch.float32).reshape(n, 6).contiguous()
    out = torch.empty((n, out_h, out_w, c), device=imgs.device, dtype=imgs.dtype)
    fn = _build.load("warp", "warp_band_launch", 3, 10)
    rc = fn(imgs.data_ptr(), m.data_ptr(), out.data_ptr(), n, h, w, c, out_h, out_w,
            band_w, crop_w, wp, int(imgs.dtype == torch.bfloat16),
            _build.stream_handle(imgs.device))
    _build.check_launch("warp_affine_band", rc)
    warp_affine_band.launches += 1
    return out


warp_affine_band.launches = 0
