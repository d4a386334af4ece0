"""Per-component timing of the inference pipeline, against the analytic
FLOP count of each encoder stage (ffrnet_tpu/tools/bench_stages.py).

Each row times one component alone with `utils/profiling.py::time_op`
(one pair of CUDA events around --iters calls, after 2 warm-up calls):

  stem           the stem conv + BN + PReLU
  stage1-stage4  IR-SE50's `body[lo:hi]` (3, 4, 14 and 3 units; one
                 `se_gating` launch per unit)
  encoder_full   the whole encoder (24 `se_gating` launches)
  recnet         RecNet (`RecNetConfig()`, one `channel_branch` launch) on a
                 7x7x512 map of random normals
  cp2tform_solve `ops/align.py::similarity_transform`: a float64 solve on
                 the host and the matrices' upload. The CUDA events then
                 time the host as well, which is what an align call pays.
  warp_band      the band kernel at the crop_w that
                 `ops/align.py::auto_band_crop_w` proves for the landmarks
                 (the serving configuration)
  warp_full      the full kernel (`ops/kernels/warp.py::warp_affine_full`)
                 on the same 250x250x3 canvases
  warp_gather    the plain gather warp `ops/align.py::warp_affine`, only
                 when --iters <= 4

`warp_full` stands where the JAX tool has `warp_tiled` and `warp_rowcrop`,
XLA strategies of the TPU that the port does not have (`ops/align.py`
refuses them by name). --int8 1 adds `encoder_int8` (52 `int8_conv` + 24
`se_gating` a call) and `recnet_int8` (15 `int8_conv` + 1
`channel_branch`), their static scales through the scale cache
(`tools/int8_cache.py`), and `int8_stage_shares`, the int8 serving
pipeline as a sum of its stages.

--stem_duel 1 adds `stem_duel`, an A/B of the stem conv alone (no BN or
PReLU), each arm's ms and its max_abs_err against `prod`:

  prod    F.conv2d at C=3 (the encoder's stem)
  im2col  F.unfold to (N, 27, H*W) patches, then one (., 27) x (27, 64)
          product (cuBLAS and oneDNN accumulate a bf16 product in fp32
          and round once), cast back, plus the bias
  padc    both operands zero-padded from 3 to 8 input channels
          (`models/optimize.py::pad_stem_input_channels`' weight)

The C=3 input gives the implicit GEMM a 27-wide contraction; the duel
measures what that costs on the tensor cores.

Rows named in `stage_flops` carry `tflops`. An fp32 run switches TF32 off
(process-wide, as `FFRNet.prepare` does), so fp32 is fp32.

    python -m ffrnet_torch.tools.bench_stages [--batch 256] [--dtype bf16]
        [--iters 8] [--fold_bn 1] [--int8 0] [--stem_duel 0] [--device cuda]

Prints one JSON line {"batch", "dtype", "results"} and returns it as a dict.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

# stage boundaries in the flat unit list for num_layers=50:
# (unit_lo, unit_hi, input_hw, in_ch_first, out_ch)
_STAGES_50 = [(0, 3, 112, 64, 64), (3, 7, 56, 64, 128),
              (7, 21, 28, 128, 256), (21, 24, 14, 256, 512)]


def _unit_flops(h_in, cin, cout, stride):
    """MAC*2 for one IR-SE unit: conv1 3x3 s1 at input res + conv2 3x3
    stride + (projection shortcut if cin != cout)."""
    h_out = h_in // stride
    f = h_in * h_in * 9 * cin * cout * 2          # conv1
    f += h_out * h_out * 9 * cout * cout * 2      # conv2
    if cin != cout:
        f += h_out * h_out * cin * cout * 2       # 1x1 projection
    return f


def stage_flops(batch):
    from ffrnet_torch.models.irse import unit_configs

    units = unit_configs(50)
    flops = {}
    for si, (lo, hi, hw, _, _) in enumerate(_STAGES_50, start=1):
        total, h = 0, hw
        for (cin, cout, stride) in units[lo:hi]:
            total += _unit_flops(h, cin, cout, stride)
            h //= stride
        flops[f"stage{si}"] = total * batch
    flops["stem"] = 112 * 112 * 9 * 3 * 64 * 2 * batch
    flops["head"] = (512 * 7 * 7) * 512 * 2 * batch
    return flops


def stem_fn(model):
    """The encoder's stem alone: conv 3x3 + BN + PReLU, NCHW."""
    from ffrnet_torch.models.irse import _bn
    from ffrnet_torch.ops import nn as ops

    conv, bn, prelu = model.input_layer
    return lambda x: ops.prelu(_bn(bn, F.conv2d(x, conv.weight, conv.bias, stride=1,
                                                padding=1)), prelu.weight, axis=1)


def stem_patches(x):
    """(N, 27, H*W) 3x3 patches of the NCHW stem input (stride 1, padding
    1), rows in (channel, kernel row, kernel column) order: the order of
    lax.conv_general_dilated_patches and of an OIHW weight's rows."""
    return F.unfold(x, 3, padding=1)


def stem_duel_fns(conv):
    """{arm: fn(x)} of the stem conv alone, NCHW (the JAX tool's arms,
    ffrnet_tpu/tools/bench_stages.py:177-219)."""
    w, b = conv.weight, conv.bias
    w_flat = w.reshape(w.shape[0], -1).t()  # (27, 64); JAX's (2, 0, 1, 3) of HWIO
    w_pad = F.pad(w, (0, 0, 0, 0, 0, 8 - w.shape[1]))

    def prod(x):
        return F.conv2d(x, w, b, stride=1, padding=1)

    def im2col(x):
        n, _, h, wd = x.shape
        y = torch.matmul(stem_patches(x).transpose(1, 2), w_flat)  # (N, H*W, 64)
        y = y.transpose(1, 2).reshape(n, -1, h, wd)
        return y if b is None else y + b.reshape(1, -1, 1, 1)

    def padc(x):
        xp = F.pad(x, (0, 0, 0, 0, 0, w_pad.shape[1] - x.shape[1]))
        return F.conv2d(xp, w_pad, b, stride=1, padding=1)

    return {"prod": prod, "im2col": im2col, "padc": padc}


def stem_duel(conv, x, iters):
    """{arm: {"ms", "max_abs_err"}}: each arm's ms per call (time_op) and
    its largest difference from `prod` on `x`, in fp32."""
    from ffrnet_torch.utils.profiling import time_op

    fns = stem_duel_fns(conv)
    with torch.inference_mode():
        ref = fns["prod"](x).float()
    duel = {}
    for name, fn in fns.items():
        with torch.inference_mode():
            err = float((fn(x).float() - ref).abs().max())
        duel[name] = {"ms": round(time_op(fn, x, iters), 3), "max_abs_err": err}
        print(f"[stem_duel] {name}: {duel[name]}", file=sys.stderr, flush=True)
    return duel


def stage_fn(model, lo, hi):
    """The units `body[lo:hi]` of the encoder, run in order."""
    units = model.body[lo:hi]

    def run(x):
        for unit in units:
            x = unit(x)
        return x

    return run


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--dtype", type=str, default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--fold_bn", type=int, default=1)
    p.add_argument("--int8", type=int, default=0,
                   help="add int8-static encoder/RecNet rows (through the scale cache) and "
                        "the int8 serving-pipeline stage-share table")
    p.add_argument("--stem_duel", type=int, default=0,
                   help="A/B the stem conv alone: F.conv2d at C=3, an im2col product and "
                        "a conv on channels zero-padded to 8, each against the first")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ffrnet_torch.api import resolve_device
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.models.recnet import RecNetConfig, build_recnet
    from ffrnet_torch.ops.align import (ARCFACE_REF_PTS, auto_band_crop_w, cv2_transform,
                                        similarity_transform, warp_affine)
    from ffrnet_torch.ops.kernels.warp import warp_affine_band, warp_affine_full
    from ffrnet_torch.utils.profiling import time_op

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    if dev.type == "cuda" and dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    b = args.batch
    enc = build_backbone(generator=torch.Generator().manual_seed(0))
    if args.fold_bn:
        from ffrnet_torch.models.optimize import fold_backbone_bn

        enc = fold_backbone_bn(enc)
    enc = enc.to(dev, dtype)

    rng = np.random.default_rng(0)

    def rand(*shape):
        """Normals drawn NHWC (the JAX tool's order), NCHW on the device."""
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(dev, dtype).permute(0, 3, 1, 2).contiguous()

    results = {}
    flops = stage_flops(b)

    def record(name, ms):
        entry = {"ms": round(ms, 3)}
        if name in flops:
            entry["tflops"] = round(flops[name] / (ms * 1e-3) / 1e12, 1)
        results[name] = entry
        print(f"[stages] {name}: {entry}", file=sys.stderr, flush=True)

    x = rand(b, 112, 112, 3)
    record("stem", time_op(stem_fn(enc), x, args.iters))
    for si, (lo, hi, hw, cin, _) in enumerate(_STAGES_50, start=1):
        record(f"stage{si}", time_op(stage_fn(enc, lo, hi), rand(b, hw, hw, cin), args.iters))
    record("encoder_full", time_op(lambda x: enc(x)[1], x, args.iters))

    cfg = RecNetConfig()
    rec = build_recnet(cfg, generator=torch.Generator().manual_seed(1)).to(dev, dtype)
    fm = rand(b, 7, 7, 512)
    record("recnet", time_op(lambda z: rec(z)[0], fm, args.iters))

    # alignment: solve + warps, on canvases of the LFW image size
    raw = torch.from_numpy(rng.uniform(0, 255, (b, 250, 250, 3))).to(dev, dtype)
    lmk = (ARCFACE_REF_PTS[None] * 2.0 + rng.normal(0, 2, (b, 5, 2)) + 20).astype(np.float32)
    ref = np.broadcast_to(ARCFACE_REF_PTS, lmk.shape)
    mats = cv2_transform(lmk, ref).to(dev)
    lmk_dev = torch.from_numpy(lmk).to(dev)
    record("cp2tform_solve", time_op(
        lambda l: similarity_transform(l, ref).to(dev), lmk_dev, args.iters))
    crop_w = auto_band_crop_w(lmk, ARCFACE_REF_PTS, (250, 250), 112)
    if crop_w is None:
        raise ValueError("bench_stages: no band window covers the landmarks' transforms")
    record("warp_band", time_op(
        lambda r: warp_affine_band(r, mats, out_hw=(112, 112), crop_w=crop_w), raw,
        args.iters))
    record("warp_full", time_op(
        lambda r: warp_affine_full(r, mats, out_hw=(112, 112), compute_dtype=dtype), raw,
        args.iters))
    if args.iters <= 4:  # the gather warp is slow; only on short runs
        record("warp_gather", time_op(lambda r: warp_affine(r, mats, out_hw=(112, 112)),
                                      raw, 2))

    if args.stem_duel:
        results["stem_duel"] = stem_duel(enc.input_layer[0], x, args.iters)

    if args.int8:
        from ffrnet_torch.models.quantize import quantize_encoder, quantize_recnet
        from ffrnet_torch.tools import int8_cache

        cache_file = int8_cache.default_cache_file()
        qenc = quantize_encoder(enc)
        senc, st_enc = int8_cache.static_encoder_tree(
            qenc, dtype, cache_file=cache_file,
            cache_key=int8_cache.encoder_cache_key(qenc, dtype_name=args.dtype))
        print(f"[stages] enc scale cache: {st_enc}", file=sys.stderr, flush=True)
        record("encoder_int8", time_op(lambda x: senc(x)[1], x, args.iters))
        qrec = quantize_recnet(rec)
        srec, st_rec = int8_cache.static_recnet_tree(
            qrec, lambda xx: enc(xx)[0], dtype, cache_file=cache_file,
            cache_key=int8_cache.recnet_cache_key(qrec, enc, dtype_name=args.dtype))
        print(f"[stages] recnet scale cache: {st_rec}", file=sys.stderr, flush=True)
        record("recnet_int8", time_op(lambda z: srec(z)[0], fm, args.iters))
        # int8 serving-pipeline stage shares: a sum of the stages timed
        # alone, not a timed pipeline (tools/bench_int8_recnet.py times one)
        stages = {k: results[k]["ms"]
                  for k in ("cp2tform_solve", "warp_band", "encoder_int8", "recnet_int8")}
        tot = sum(stages.values())
        results["int8_stage_shares"] = {
            k: {"ms": v, "share": round(v / tot, 3)} for k, v in stages.items()}
        results["int8_stage_shares"]["sum_ms"] = round(tot, 3)

    out = {"batch": b, "dtype": args.dtype, "results": results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
