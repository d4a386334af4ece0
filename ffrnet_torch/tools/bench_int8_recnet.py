"""One-process duel: does int8 quantizing RecNet's conv chains pay?
(ffrnet_tpu/tools/bench_int8_recnet.py)

  1. the isolated RecNet forward at --batch: float (--dtype; named "bf16"
     in the output, as in the JAX tool) vs dynamic int8 vs static int8
     (models/quantize.py::quantize_recnet, 15 int8_conv sites), with the
     rectified embeddings' cosines against the float arm on held-out
     feature maps;
  2. the align -> encode -> rectify -> score pipeline: uint8-range
     250x250x3 canvases and noisy landmarks, aligned to 112x112, the static
     int8 encoder, then RecNet float or static int8, and pair cosines of
     rows (0, 1), (2, 3), ...

RecNet's static scales and the encoder's come through the scale cache
(tools/int8_cache.py); RecNet calibrates on the float encoder's feature
maps. The models are the port's random ones: IR-SE50 from
torch.Generator seed 0, BN folded; RecNet (the fused default
configuration) from seed 1; both cast to --dtype.

What became of the JAX tool's relay workarounds and TPU strategies:
`utils/profiling.py::time_op` brackets the --iters calls of an arm with
one pair of CUDA events (no chained token); calibration runs on the card.
The align step is the port's `ops/align.py::align_faces` (the band kernel,
or the full kernel where no band covers a transform) in place of JAX's
`warp_affine_tiled`, a TPU strategy that is not ported. Its cp2tform is one
float64 solve on the host per call, which the pipeline's time includes;
the JAX tool solved on the device.

    python -m ffrnet_torch.tools.bench_int8_recnet [--batch 256]
        [--pipeline_batches 256,512] [--skip_pipeline] [--device cuda]

The encoder is always BN-folded; the cache keys fingerprint the weights
the scales come from (the JAX tool's FFRNET_BENCH_FOLD_BN named the fold
in its keys without changing the model, and is not ported). Prints one
JSON line (the JAX tool's keys) and returns it as a dict.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--dtype", type=str, default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--cal_batch", type=int, default=8)
    p.add_argument("--skip_pipeline", action="store_true")
    p.add_argument("--pipeline_batches", type=str, default="",
                   help="comma-separated pipeline batch sizes (default: --batch); all run "
                        "in one process so per-face rates are comparable across sizes")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    pipeline_batches = ([int(x) for x in args.pipeline_batches.split(",")]
                        if args.pipeline_batches else [args.batch])

    from ffrnet_torch.api import resolve_device
    from ffrnet_torch.eval.lfw import pair_cosine
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.models.optimize import fold_backbone_bn
    from ffrnet_torch.models.quantize import quantize_encoder, quantize_recnet
    from ffrnet_torch.models.recnet import RecNetConfig, build_recnet
    from ffrnet_torch.ops.align import ARCFACE_REF_PTS, align_faces
    from ffrnet_torch.tools import int8_cache
    from ffrnet_torch.tools.bench_int8 import cosines
    from ffrnet_torch.utils.profiling import time_op

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    b = args.batch
    cache_file = int8_cache.default_cache_file()
    out = {"tool": "bench_int8_recnet", "dtype": args.dtype, "batch": b}

    enc = fold_backbone_bn(build_backbone(generator=torch.Generator().manual_seed(0)))
    enc = enc.to(dev, dtype)
    rec = build_recnet(RecNetConfig(), generator=torch.Generator().manual_seed(1))
    rec = rec.to(dev, dtype)

    def enc_fwd(x):
        return enc(x)[0]

    # RecNet's scales from the float encoder's feature maps of the cache's
    # calibration batch (default_rng(2)), disjoint from the inputs below
    # (default_rng(0)): the cosines are held out
    qrec = quantize_recnet(rec)
    srec, out["recnet_scales_cache"] = int8_cache.static_recnet_tree(
        qrec, enc_fwd, dtype, cache_file=cache_file, cal_batch=args.cal_batch,
        cache_key=int8_cache.recnet_cache_key(qrec, enc, dtype_name=args.dtype,
                                              cal_batch=args.cal_batch))
    arms = {"bf16": rec, "dynamic": quantize_recnet(rec), "static": srec}

    # --- duel 1: isolated RecNet forward ------------------------------------
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        # real feature-map statistics, not gaussian noise, so activation
        # ranges are honest
        x = torch.from_numpy(rng.uniform(-1.0, 1.0, (b, 112, 112, 3)).astype(np.float32))
        fm_eval = enc_fwd(x.to(dev, dtype).permute(0, 3, 1, 2).contiguous())
        v_ref = rec(fm_eval)[0]
        iso = {}
        for k in ("dynamic", "static"):
            iso[f"cos_mean_{k}"], iso[f"cos_min_{k}"] = (
                round(c, 5) for c in cosines(v_ref, arms[k](fm_eval)[0]))
    ms = {k: [] for k in arms}
    for _ in range(args.rounds):
        for k, model in arms.items():
            ms[k].append(time_op(lambda fm, m=model: m(fm)[0], fm_eval, iters=args.iters))
    for k, v in ms.items():
        iso[f"recnet_ms_{k}"] = round(min(v), 3)
    for k in ("dynamic", "static"):
        iso[f"speedup_{k}"] = round(
            iso["recnet_ms_bf16"] / max(iso[f"recnet_ms_{k}"], 1e-9), 3)
    out["isolated"] = iso
    print(f"[bench_int8_recnet] isolated: {iso}", file=sys.stderr, flush=True)

    # --- duel 2: the pipeline ----------------------------------------------
    # per batch size, interleaved float- vs int8-RecNet arms on the static
    # int8 encoder, all in one process so per-face rates compare across sizes
    if not args.skip_pipeline:
        qenc = quantize_encoder(enc)
        senc, out["enc_scales_cache"] = int8_cache.static_encoder_tree(
            qenc, dtype, cache_file=cache_file,
            cache_key=int8_cache.encoder_cache_key(qenc, dtype_name=args.dtype))
        out["pipeline"] = {}
        for pb in pipeline_batches:
            raw = torch.from_numpy(rng.uniform(0, 255, (pb, 250, 250, 3))).to(dev, dtype)
            lmk = (ARCFACE_REF_PTS[None] * 2.1 + rng.normal(0, 2, (pb, 5, 2)) + 15).astype(
                np.float32)

            def pipe(raw_in, rec_model, lmk=lmk):
                al = align_faces(raw_in, lmk, out_hw=(112, 112), ref_pts=ARCFACE_REF_PTS)
                x = (al.to(dtype) / 127.5 - 1.0).permute(0, 3, 1, 2).contiguous()
                v = rec_model(senc(x)[0])[0]
                return pair_cosine(v[0::2].float(), v[1::2].float())

            ms_b, ms_q = [], []
            for _ in range(args.rounds):
                ms_b.append(time_op(lambda r: pipe(r, rec), raw, iters=args.iters))
                ms_q.append(time_op(lambda r: pipe(r, srec), raw, iters=args.iters))
            best_b, best_q = min(ms_b), min(ms_q)
            sec = {
                "arms": "int8_static_enc + {bf16, int8_static} recnet",
                "pipeline_ms_rec_bf16": round(best_b, 3),
                "pipeline_ms_rec_int8": round(best_q, 3),
                "faces_per_sec_rec_bf16": round(pb / (best_b / 1e3), 1),
                "faces_per_sec_rec_int8": round(pb / (best_q / 1e3), 1),
                "speedup": round(best_b / max(best_q, 1e-9), 3),
                "rounds_ms_rec_bf16": [round(v, 3) for v in ms_b],
                "rounds_ms_rec_int8": [round(v, 3) for v in ms_q],
            }
            out["pipeline"][str(pb)] = sec
            print(f"[bench_int8_recnet] pipeline b{pb}: {sec}", file=sys.stderr, flush=True)

    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
