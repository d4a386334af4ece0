"""Long-horizon int8-encoder convergence A/B with eval-protocol deltas
(ffrnet_tpu/tools/bench_int8_convergence.py).

--steps updates at a class count and noise level where accuracy does not
saturate early, with the 10-fold verification protocol (eval/lfw.py's fold
sweep) scored at checkpoints on a held-out synthetic ocl-1 pair set.

Arms (train.py's --int8_encoder switch):
  float        -- the frozen encoder in the compute type in the step
  int8_static  -- train.py::prepare_int8_encoder (BN folded, int8 sites,
                  static scales calibrated on the first --cal_images
                  samples)
Both arms train the same RecNet init (seed 1 + --seed) on the same data
stream (batch keys --seed * 100000 + step, tools/synth.py), and both are
scored with the fp32 float encoder, as train.py's LFW eval keeps the
float encoder. The int8 arm also gets an arm-consistent column
(eval_acc_rect_armenc): its own encoder, with a copy of RecNet and the
images cast to the compute type, which separates the train/eval feature
mismatch from damage to RecNet.

A checkpoint scores RecNet in eval mode (running statistics, no update of
them) and puts it back in train mode after, also when the scoring raises,
as train.py::eval_lfw does; the training state itself is never cast.

What became of the JAX tool's relay workarounds: the data and the loop
already run on the device there; here the batches come from device
generators too (no host draw per step). The port's train_step takes the
encoder already in the compute type, so the float arm trains on a cast
copy.

    python -m ffrnet_torch.tools.bench_int8_convergence [--steps 600] [--batch 64]
        [--num_classes 256] [--noise 0.35] [--out PATH] [--device cuda]

Writes --out (never the JAX tool's docs/int8_convergence.json), prints one
JSON line (tool, config, deltas_int8_minus_float, wall_s) and returns the
whole record.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import torch

from ffrnet_torch.eval.lfw import kfold_verification
from ffrnet_torch.eval.runner import make_pair_score_fn
from ffrnet_torch.tools.synth import make_batch_fn, make_eval_pairs
from ffrnet_torch.training.trainer import train_step


def eval_ckpt(recnet, float_encoder, pairs, arm_encoder=None):
    """(rectified acc, raw acc[, arm-consistent rectified acc]) of `recnet`
    on `pairs` = (img1, img2, labels): the fp32 `float_encoder`, and with
    `arm_encoder` also that encoder with a copy of RecNet and the images in
    its dtype. RecNet is scored in eval mode and left in the mode it had."""
    img1, img2, labels = pairs
    was_training = recnet.training
    recnet.eval()
    try:
        s_raw, s_new = make_pair_score_fn(float_encoder, recnet)(img1, img2)
        res = [kfold_verification(s_new, labels), kfold_verification(s_raw, labels)]
        if arm_encoder is not None:
            cdt = arm_encoder.input_layer[0].weight.dtype
            rec = copy.deepcopy(recnet).to(cdt)
            _, s_arm = make_pair_score_fn(arm_encoder, rec)(img1.to(cdt), img2.to(cdt))
            res.append(kfold_verification(s_arm, labels))
    finally:
        recnet.train(was_training)
    return tuple(float(r.mean_accuracy) for r in res)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--num_classes", type=int, default=256)
    p.add_argument("--noise", type=float, default=0.35)
    p.add_argument("--ckpt_every", type=int, default=100)
    p.add_argument("--eval_pairs", type=int, default=600)
    p.add_argument("--dtype", type=str, default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--cal_images", type=int, default=8)
    p.add_argument("--seed", type=int, default=0,
                   help="offsets every random stream (data templates, encoder init, RecNet "
                        "init, eval pairs, per-step keys) so a second run is an "
                        "independent replicate")
    p.add_argument("--out", type=str, default="chiprun_out/int8_convergence.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ffrnet_torch.api import resolve_device
    from ffrnet_torch.data.datasets import SyntheticPairs
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.models.recnet import RecNetConfig
    from ffrnet_torch.train import prepare_int8_encoder
    from ffrnet_torch.training.trainer import TrainerConfig, create_train_state

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # the fp32 scoring encoder keeps fp32 numerics, as train.py's
        # load_encoder sets it for its LFW eval
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    n_ids = args.num_classes
    # the host dataset only feeds calibration (prepare_int8_encoder samples
    # its first images); the training data is drawn on the device from the
    # same templates and noise model
    ds = SyntheticPairs(num_identities=n_ids, samples_per_id=4, seed=3 + args.seed,
                        noise=args.noise)
    encoder = build_backbone(generator=torch.Generator().manual_seed(args.seed), device=dev)
    arms = {"float": copy.deepcopy(encoder).to(dtype),
            "int8_static": prepare_int8_encoder(encoder, ds, args.dtype,
                                                cal_images=args.cal_images)}

    templates = torch.from_numpy(ds.templates).to(dev)
    make_batch = make_batch_fn(templates, args.batch, n_ids, args.noise)
    pairs = make_eval_pairs(templates, 42 + args.seed, args.eval_pairs, n_ids, args.noise)
    cfg = TrainerConfig(optimizer="adam", lr=args.lr, compute_dtype=args.dtype,
                        recnet=RecNetConfig(num_classes=n_ids))

    t_start = time.perf_counter()
    curves = {}
    for name, step_encoder in arms.items():
        st = create_train_state(cfg, seed=1 + args.seed, device=dev)
        arm_encoder = step_encoder if name != "float" else None
        curve = []
        for step in range(1, args.steps + 1):
            # the same key sequence in every arm: the same data stream
            st, m = train_step(step_encoder, st, make_batch(args.seed * 100000 + step),
                               cfg=cfg)
            if step % args.ckpt_every == 0 or step == args.steps:
                accs = eval_ckpt(st.model, encoder, pairs, arm_encoder)
                curve.append({
                    "step": step,
                    "TrainAcc": round(float(m["TrainAcc"]), 4),
                    "TotalLoss": round(float(m["TotalLoss"]), 4),
                    "eval_acc_rect": round(accs[0], 4),
                    "eval_acc_raw": round(accs[1], 4),
                })
                if arm_encoder is not None:
                    curve[-1]["eval_acc_rect_armenc"] = round(accs[2], 4)
                print(f"[{name}] {curve[-1]}", file=sys.stderr, flush=True)
        curves[name] = curve

    deltas = [
        {"step": f_["step"],
         "d_eval_rect": round(i_["eval_acc_rect"] - f_["eval_acc_rect"], 4),
         "d_eval_raw": round(i_["eval_acc_raw"] - f_["eval_acc_raw"], 4),
         "d_TrainAcc": round(i_["TrainAcc"] - f_["TrainAcc"], 4)}
        for f_, i_ in zip(curves["float"], curves["int8_static"])
    ]
    out = {
        "tool": "bench_int8_convergence",
        "config": {"steps": args.steps, "batch": args.batch,
                   "num_classes": n_ids, "noise": args.noise,
                   "dtype": args.dtype, "lr": args.lr,
                   "eval_pairs": args.eval_pairs, "seed": args.seed,
                   "eval_protocol": "10-fold threshold sweep, ocl-1 pairs, "
                                    "float encoder both arms"},
        "arms": curves,
        "deltas_int8_minus_float": deltas,
        "wall_s": round(time.perf_counter() - t_start, 1),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in
                      ("tool", "config", "deltas_int8_minus_float", "wall_s")}))
    return out


if __name__ == "__main__":
    main()
