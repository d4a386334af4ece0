"""Int8 accuracy-budget table (ffrnet_tpu/tools/bench_int8_budget.py).

Full 10-fold verification-protocol deltas (eval/lfw.py's fold sweep, the
same code the LFW evaluator runs), int8 minus float,

  across --seeds seeds       (encoder init / RecNet init / data),
  margins --margins          (x_scale = margin * amax / 127),
  split by quantized model   (encoder only / RecNet only / all),

on a briefly trained RecNet (--train_steps Adam steps on synthetic
identities drawn on the device, tools/synth.py), so the rectified branch
measures signal and not a random projection. Pairs are ocl-1 (img1 clean,
img2 masked), where the rectified path matters most.

Per seed s: SyntheticPairs(seed=7+s) templates, train batches keyed by
step, eval pairs keyed 1000+s; the encoder from torch.Generator seed s,
RecNet's state from seed 100+s. The float reference is the BN-folded
encoder cast to --dtype with the trained RecNet cast to --dtype in eval
mode: the model the int8 path quantizes, so a delta is quantization error
alone. Calibration runs once per seed, on the first --cal_images clean
samples (default_rng(0)), the encoder's feature maps feeding RecNet's; each
margin rescales those scales.

What became of the JAX tool's relay workarounds: calibration runs on the
card (the JAX tool moved it to the host CPU). The port's train_step takes
the encoder already in the compute type (the JAX step cast inside it), so
the steps run on a copy cast to --dtype.

    python -m ffrnet_torch.tools.bench_int8_budget [--seeds 3] [--train_steps 200]
        [--out PATH] [--device cuda]

Writes --out (never the JAX tool's docs/int8_budget.json), prints one JSON
line (tool, summary, wall_s) and returns the whole record.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np
import torch

from ffrnet_torch.eval.runner import evaluate_pairs, make_pair_score_fn
from ffrnet_torch.models.quantize import quantized_sites
from ffrnet_torch.tools.synth import make_batch_fn, make_eval_pairs
from ffrnet_torch.training.trainer import train_step

SPLITS = ("enc_only", "recnet_only", "all")
EVAL_BATCH = 200


def _with_margin(model, margin: float):
    """A copy of a calibrated int8 model with each x_scale rescaled by the
    budget's formula, fp32(float(x_scale) * margin) (the amaxes do not
    depend on the margin, so one calibration serves the sweep)."""
    out = copy.deepcopy(model)
    for _, site in quantized_sites(out):
        site.x_scale = torch.tensor(np.float32(float(site.x_scale) * margin),
                                    device=site.x_scale.device)
    return out


def split_models(fenc, frec, enc_m, rec_m):
    """{split: (encoder, RecNet)}: each split's int8 models, float ones
    elsewhere."""
    return dict(zip(SPLITS, ((enc_m, frec), (fenc, rec_m), (enc_m, rec_m))))


def accuracies(encoder, recnet, batches):
    """(rectified, raw) 10-fold mean accuracies of `encoder` + `recnet`
    (both in eval mode) on the pair batches."""
    res_new, res_raw = evaluate_pairs(make_pair_score_fn(encoder, recnet), batches)
    return float(res_new.mean_accuracy), float(res_raw.mean_accuracy)


def summarize(rows, margins):
    """Worst |delta| and mean delta per (margin, split) across seeds."""
    summary = {}
    for margin in margins:
        for split in SPLITS:
            sel = [r for r in rows if r["margin"] == margin and r["split"] == split]
            summary[f"m{margin}/{split}"] = {
                "worst_abs_d_rect": max(abs(r["d_rect"]) for r in sel),
                "worst_abs_d_raw": max(abs(r["d_raw"]) for r in sel),
                "mean_d_rect": round(float(np.mean([r["d_rect"] for r in sel])), 4),
                "mean_d_raw": round(float(np.mean([r["d_raw"] for r in sel])), 4),
            }
    return summary


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--train_steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--num_classes", type=int, default=128)
    p.add_argument("--noise", type=float, default=0.25)
    p.add_argument("--eval_pairs", type=int, default=600)
    p.add_argument("--margins", type=str, default="0.75,1.0")
    p.add_argument("--dtype", type=str, default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--cal_images", type=int, default=8)
    p.add_argument("--out", type=str, default="chiprun_out/int8_budget.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    margins = [float(m) for m in args.margins.split(",")]

    from ffrnet_torch.api import resolve_device
    from ffrnet_torch.data.datasets import SyntheticPairs
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.models.optimize import fold_backbone_bn
    from ffrnet_torch.models.quantize import (calibrate_activation_scales,
                                              calibrate_recnet_activation_scales,
                                              quantize_encoder, quantize_recnet)
    from ffrnet_torch.models.recnet import RecNetConfig
    from ffrnet_torch.training.trainer import TrainerConfig, create_train_state

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    n_ids = args.num_classes
    cfg = TrainerConfig(optimizer="adam", lr=1e-3, compute_dtype=args.dtype,
                        recnet=RecNetConfig(num_classes=n_ids))
    t_start = time.perf_counter()
    rows = []

    for s in range(args.seeds):
        ds = SyntheticPairs(num_identities=n_ids, samples_per_id=4, seed=7 + s,
                            noise=args.noise)
        templates = torch.from_numpy(ds.templates).to(dev)
        make_batch = make_batch_fn(templates, args.batch, n_ids, args.noise)
        img1, img2, lab = make_eval_pairs(templates, 1000 + s, args.eval_pairs, n_ids,
                                          args.noise)
        # staged on the device in the compute type: every model below is
        # cast to it
        batches = [{"img1": img1[i:i + EVAL_BATCH].to(dtype),
                    "img2": img2[i:i + EVAL_BATCH].to(dtype),
                    "label": lab[i:i + EVAL_BATCH]}
                   for i in range(0, args.eval_pairs, EVAL_BATCH)]

        encoder = build_backbone(generator=torch.Generator().manual_seed(s), device=dev)
        step_encoder = copy.deepcopy(encoder).to(dtype)
        st = create_train_state(cfg, seed=100 + s, device=dev)
        m = None
        for step in range(1, args.train_steps + 1):
            st, m = train_step(step_encoder, st, make_batch(step), cfg=cfg)
        del step_encoder
        if m is not None:
            print(f"[seed {s}] trained {args.train_steps} steps: TrainAcc "
                  f"{float(m['TrainAcc']):.3f}", file=sys.stderr, flush=True)

        fenc = fold_backbone_bn(encoder).to(dtype)
        frec = copy.deepcopy(st.model).to(dtype).eval()

        cal_rng = np.random.default_rng(0)
        xcal = np.stack([ds.get(i, cal_rng)["img_non"] for i in range(args.cal_images)])
        xcal = torch.from_numpy(xcal).to(dev, dtype).permute(0, 3, 1, 2).contiguous()
        fms = []
        t0 = time.perf_counter()
        cal_enc = calibrate_activation_scales(quantize_encoder(fenc), [xcal],
                                              capture_featmaps=fms)
        cal_rec = calibrate_recnet_activation_scales(quantize_recnet(frec), fms)
        print(f"[seed {s}] calibrated enc+recnet in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)

        f_rect, f_raw = accuracies(fenc, frec, batches)
        print(f"[seed {s}] float: rect {f_rect:.4f} raw {f_raw:.4f}", file=sys.stderr,
              flush=True)
        for margin in margins:
            models = split_models(fenc, frec, _with_margin(cal_enc, margin),
                                  _with_margin(cal_rec, margin))
            for split, (e, r) in models.items():
                q_rect, q_raw = accuracies(e, r, batches)
                rows.append({
                    "seed": s, "margin": margin, "split": split,
                    "float_rect": round(f_rect, 4),
                    "float_raw": round(f_raw, 4),
                    "int8_rect": round(q_rect, 4),
                    "int8_raw": round(q_raw, 4),
                    "d_rect": round(q_rect - f_rect, 4),
                    "d_raw": round(q_raw - f_raw, 4),
                })
                print(f"[seed {s}] m={margin} {split}: d_rect {rows[-1]['d_rect']:+.4f} "
                      f"d_raw {rows[-1]['d_raw']:+.4f}", file=sys.stderr, flush=True)

    summary = summarize(rows, margins)
    out = {
        "tool": "bench_int8_budget",
        "config": {"seeds": args.seeds, "train_steps": args.train_steps,
                   "num_classes": n_ids, "noise": args.noise,
                   "eval_pairs": args.eval_pairs, "dtype": args.dtype,
                   "margins": margins, "protocol": "10-fold sweep, ocl-1 "
                   "pairs, trained RecNet, folded float reference"},
        "rows": rows,
        "summary": summary,
        "wall_s": round(time.perf_counter() - t_start, 1),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"tool": out["tool"], "summary": summary, "wall_s": out["wall_s"]}))
    return out


if __name__ == "__main__":
    main()
