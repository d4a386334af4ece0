"""One-process A/B/C of the frozen IR-SE50 encoder: float vs dynamic int8
vs static int8 (ffrnet_tpu/tools/bench_int8.py).

The float arm is the serving configuration (BN folded, cast to --dtype;
named "bf16" in the output whatever --dtype is, as in the JAX tool); the
int8 arms quantize its body convs and output Linear
(models/quantize.py::quantize_encoder) and run them on the int8_conv
kernel, in both activation-scale modes:

  - dynamic: a per-batch amax pass per site (no calibration data);
  - static:  scales calibrated on --cal_batch images (default_rng(2)) and
    baked into the sites (no amax pass; out-of-range values saturate).

The arms run interleaved, --rounds times --iters calls each, across
--batches sizes; the minimum per arm is reported. The embedding cosines
against the float arm are taken on an input held out of the calibration
set (default_rng(1)), so static saturation is exercised; --margins sweeps
the calibration margin by rescaling the calibrated scales (cosines only,
no timing).

What became of the JAX tool's relay workarounds: `utils/profiling.py::
time_op` brackets the --iters calls of an arm with one pair of CUDA events
(the JAX tool chained the calls through a token to time them through its
relay), and calibration runs on the card (the JAX tool moved it to the
host CPU).

    python -m ffrnet_torch.tools.bench_int8 [--batches 128,256,512]
        [--static_scales 1] [--margins 0.5,0.75,1.0,1.25] [--device cuda]

Prints one JSON line (the JAX tool's keys) and returns it as a dict.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

import numpy as np
import torch


def cosines(a, b):
    """(mean, min) row cosine of two (N, D) embeddings, in fp32 on the host."""
    a = a.float().cpu().numpy()
    b = b.float().cpu().numpy()
    c = (a * b).sum(1) / np.maximum(np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1),
                                    1e-12)
    return float(c.mean()), float(c.min())


def with_margin(model, m: float):
    """A copy of a calibrated int8 model with each x_scale rescaled by
    bench_int8's formula, fp32(x_scale * m) in numpy float32 arithmetic
    (the amaxes do not depend on the margin, so one calibration serves the
    sweep)."""
    from ffrnet_torch.models.quantize import quantized_sites

    out = copy.deepcopy(model)
    for _, site in quantized_sites(out):
        site.x_scale = torch.tensor(np.float32(site.x_scale.cpu().numpy() * m),
                                    device=site.x_scale.device)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--batches", type=str, default="",
                   help="comma-separated batch sizes; overrides --batch")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--rounds", type=int, default=3,
                   help="interleaved A/B repetitions; min per arm reported")
    p.add_argument("--dtype", type=str, default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--quant_linear", type=int, default=1)
    p.add_argument("--static_scales", type=int, default=1,
                   help="include the calibrated static-scale arm")
    p.add_argument("--margins", type=str, default="",
                   help="calibration-margin sweep (held-out cosine only), e.g. 0.5,0.75,1.0,1.5")
    p.add_argument("--cal_batch", type=int, default=16, help="calibration set size")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ffrnet_torch.api import resolve_device
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.models.optimize import fold_backbone_bn
    from ffrnet_torch.models.quantize import calibrate_activation_scales, quantize_encoder
    from ffrnet_torch.tools.int8_cache import uniform_faces
    from ffrnet_torch.utils.profiling import time_op

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    batches = [int(b) for b in args.batches.split(",")] if args.batches else [args.batch]
    margins = [float(m) for m in args.margins.split(",")] if args.margins else []

    enc = build_backbone(generator=torch.Generator().manual_seed(0))
    enc = fold_backbone_bn(enc).to(dev, dtype)
    qenc = quantize_encoder(enc, quantize_linear=bool(args.quant_linear))

    cal = static = None
    if args.static_scales or margins:
        cal = calibrate_activation_scales(
            qenc, [uniform_faces(args.cal_batch, 2, dtype, dev)])
        if args.static_scales:
            static = cal

    def fwd(model):
        return lambda x: model(x)[1]

    out = {
        "tool": "bench_int8",
        "dtype": args.dtype,
        "quant_linear": bool(args.quant_linear),
        "arms": ["bf16", "int8_dynamic", "int8_static"] if static is not None
        else ["bf16", "int8_dynamic"],
        "per_batch": {},
    }
    f_float, f_int8 = fwd(enc), fwd(qenc)
    f_static = fwd(static) if static is not None else None
    for b in batches:
        x = uniform_faces(b, 1, dtype, dev)  # held out
        with torch.inference_mode():
            emb_f = f_float(x)
            cos_d = cosines(emb_f, f_int8(x))
            cos_s = cosines(emb_f, f_static(x)) if f_static else None
        ms_f, ms_q, ms_s = [], [], []
        for _ in range(args.rounds):
            ms_f.append(time_op(f_float, x, iters=args.iters))
            ms_q.append(time_op(f_int8, x, iters=args.iters))
            if f_static is not None:
                ms_s.append(time_op(f_static, x, iters=args.iters))
        best_f, best_q = min(ms_f), min(ms_q)
        rec = {
            "encoder_ms_float": round(best_f, 3),
            "encoder_ms_int8": round(best_q, 3),
            "speedup_dynamic": round(best_f / max(best_q, 1e-9), 3),
            "imgs_per_sec_int8": round(b / (best_q / 1e3), 1),
            "embed_cos_mean": cos_d[0],
            "embed_cos_min": cos_d[1],
            "rounds_ms_float": [round(v, 3) for v in ms_f],
            "rounds_ms_int8": [round(v, 3) for v in ms_q],
        }
        if ms_s:
            best_s = min(ms_s)
            rec.update({
                "encoder_ms_int8_static": round(best_s, 3),
                "speedup_static": round(best_f / max(best_s, 1e-9), 3),
                "imgs_per_sec_static": round(b / (best_s / 1e3), 1),
                "embed_cos_mean_static": cos_s[0],
                "embed_cos_min_static": cos_s[1],
                "rounds_ms_int8_static": [round(v, 3) for v in ms_s],
            })
        out["per_batch"][str(b)] = rec
        print(f"[bench_int8] batch {b}: {rec}", file=sys.stderr, flush=True)

    if margins:
        b = max(batches)
        x = uniform_faces(b, 1, dtype, dev)  # held out
        sweep = {}
        with torch.inference_mode():
            emb_f = f_float(x)
            for m in margins:
                mean, mn = cosines(emb_f, fwd(with_margin(cal, m))(x))
                sweep[str(m)] = {"cos_mean": mean, "cos_min": mn}
                print(f"[bench_int8] margin {m}: mean {mean:.5f} min {mn:.5f}",
                      file=sys.stderr, flush=True)
        out["margin_sweep_heldout"] = {"batch": b, "margins": sweep}

    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
