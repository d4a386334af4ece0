"""Roofline bounds of the port's hand-written kernels, from shapes, and the
H100's published peaks.

`roof`, `se_bound`, `cb_bound` and `int8_bound` are copies of
`chip_smoke.py`'s, kept here so that a change to the program cannot
change the yardstick: inputs read once and outputs written once at
the HBM rate, operations at the rate of the unit that must do them.
`int8_site_calls` lists the calls of one int8 IR-SE50 forward from the
model's shapes, and `warp_footprint_pixels` counts the source pixels a
warp needs (every pixel some bilinear tap reads), not the whole canvas.
"""

from __future__ import annotations

from benchmarks.flops import unit_configs

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
# the peak an `mfu.*` reading is a share of, by the configuration's compute type
PEAKS = {"fp32": FP32_FLOP_PER_S, "bf16": BF16_FLOP_PER_S, "int8": INT8_OPS_PER_S}

# (H, C, units) of the IR-SE50 stages: 24 SE gates per encoder forward
SE_STAGES = ((56, 64, 3), (28, 128, 4), (14, 256, 14), (7, 512, 3))


def roof(nbytes, ops):
    """(bound_ms, bound_by): the larger of `nbytes` at the HBM rate and
    `ops` at the fp32 SIMT rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def se_bound(n, itemsize, stages=SE_STAGES):
    """(bound_ms, bound_by) of the SE gates of `stages` (H, C, gates) at
    batch n: each map read once and written once, the weights read once;
    the pool, the two mat-vecs and the scale in fp32."""
    nbytes = ops = 0
    for h, c, units in stages:
        r, hw = c // 16, h * h
        nbytes += units * (2 * n * c * hw + 2 * c * r) * itemsize
        ops += units * (2 * n * c * hw + 4 * n * c * r)
    return roof(nbytes, ops)


def cb_bound(n, itemsize=4, c=512, hw=49):
    """(bound_ms, bound_by) of channel_branch at batch n: the largest of
    its two products h W5^T and M X on the tensor cores as 3xTF32 (M X as
    2xTF32 in bf16, whose X is exact in TF32), the rest (t, h, the two
    affines) on fp32 SIMT, and the bytes (x read once, out written once,
    fp32 weights read once)."""
    logits, values = 2 * n * c * c * 32, 2 * n * c * c * hw
    passes = 3 if itemsize == 4 else 2
    t_tc = (3 * logits + passes * values) / TF32_FLOP_PER_S * 1e3
    rest = n * (2 * 32 * c * hw + 4 * c * 32 * hw + 4 * c * 32 * 32)
    t_ops = rest / FP32_FLOP_PER_S * 1e3
    nbytes = (2 * n * c * hw * itemsize
              + (32 * (hw + c) + 2 * 32 * 32 + c * 32 + 3 * c + 4 * 32 + c) * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by = f"tensor cores ({'3xTF32' if itemsize == 4 else '3xTF32, M X 2xTF32'})"
    return max((t_tc, by), (t_ops, "operations"), (t_bytes, "bytes"))


def warp_ops(n, p_out=112 * 112, ch=3):
    """Per output pixel 8 operations for its coordinates, 12 for its four
    tent weights, 9 per channel for the 2x2 taps."""
    return n * p_out * (20 + 9 * ch)


def warp_band_bound(src_pixels, n, itemsize=4, ch=3, p_out=112 * 112):
    """(bound_ms, bound_by) of one warp call that reads `src_pixels` source
    pixels (`warp_footprint_pixels`. count) of `ch` channels, writes n
    (112, 112, ch) crops and reads n matrices."""
    nbytes = (src_pixels * ch + n * 6 + n * p_out * ch) * itemsize
    return roof(nbytes, warp_ops(n, p_out, ch))


def int8_bound(calls):
    """(bound_ms, bound_by) of int8_conv calls, each (x_shape (N, H, W, Cp),
    w_shape (Coutp, KH, KW, Cp), cout, has_bias, stride, padding,
    out_itemsize): the int8 input, the int8 weights and the output moved
    once at the HBM rate, or 2 N Ho Wo Cout KH KW C operations at the int8
    tensor-core rate, whichever is larger for the whole set."""
    nbytes = ops = 0
    for (n, h, w, cp), (_, kh, kw, _), cout, has_bias, stride, pad, out_itemsize in calls:
        ho, wo = (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1
        ops += 2 * n * ho * wo * cout * kh * kw * cp
        nbytes += (n * h * w * cp + cout * kh * kw * cp + n * cout * ho * wo * out_itemsize
                   + 4 * cout * (1 + has_bias))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _pad64(c):
    return -(-c // 64) * 64


def int8_site_calls(n, out_itemsize=2, folded=True):
    """The 52 int8_conv calls of one int8 IR-SE50 forward at batch n
    (`int8_bound`'s tuples), in the order they run: per unit the
    projection shortcut (1x1, the unit's stride; its BN folded into a bias),
    conv1 (3x3, stride 1, no bias: a PReLU follows) and conv2 (3x3, the
    unit's stride; folded), then the output Linear
    as a 1x1 product over (n, 1, 1, 25088)."""
    calls, h = [], 112
    for cin, depth, stride in unit_configs():
        cp, dp = _pad64(cin), _pad64(depth)
        if cin != depth:
            calls.append(((n, h, h, cp), (dp, 1, 1, cp), depth, folded, stride, 0,
                          out_itemsize))
        calls.append(((n, h, h, cp), (dp, 3, 3, cp), depth, False, 1, 1, out_itemsize))
        calls.append(((n, h, h, dp), (dp, 3, 3, dp), depth, folded, stride, 1, out_itemsize))
        h //= stride
    k = 512 * 7 * 7
    calls.append(((n, 1, 1, k), (512, 1, 1, k), 512, True, 1, 0, out_itemsize))
    return calls


def warp_footprint_pixels(mats_inv, src_hw, out_hw=(112, 112)):
    """Source pixels that some bilinear tap of the warp reads, summed over
    the batch: mats_inv (N, 2, 3) dst -> src matrices (float64 tensor);
    a tap counts where its tent weight is nonzero and it lies inside the
    source. Counted on the matrices' device."""
    import torch

    n = mats_inv.shape[0]
    h, w = src_hw
    dev = mats_inv.device
    ys, xs = torch.meshgrid(torch.arange(out_hw[0], dtype=torch.float64, device=dev),
                            torch.arange(out_hw[1], dtype=torch.float64, device=dev),
                            indexing="ij")
    xs, ys = xs.reshape(1, -1), ys.reshape(1, -1)
    sx = mats_inv[:, 0, 0, None] * xs + mats_inv[:, 0, 1, None] * ys + mats_inv[:, 0, 2, None]
    sy = mats_inv[:, 1, 0, None] * xs + mats_inv[:, 1, 1, None] * ys + mats_inv[:, 1, 2, None]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    seen = torch.zeros((n, h * w), dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)[:, None].expand_as(sx)
    for dy in (0, 1):
        for dx in (0, 1):
            tx, ty = x0 + dx, y0 + dy
            wt = (1 - (tx - sx).abs()).clamp_min(0) * (1 - (ty - sy).abs()).clamp_min(0)
            ok = (wt > 0) & (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
            idx = (ty.clamp(0, h - 1) * w + tx.clamp(0, w - 1)).long()
            seen[rows[ok], idx[ok]] = True
    return int(seen.sum())
