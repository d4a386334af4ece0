"""Numerical-parity report on released PyTorch weights
(ffrnet_tpu/tools/parity_check.py).

Given the released `se50.pth` (frozen encoder) and optionally `FFRNet.pth`
(RecNet), this tool:
  1. reads the weights with `checkpoint/pth_io.py` and checks the
     encoder's keys (`models/irse.py::check_state_dict`);
  2. runs the port, fp32 with BN unfolded, on --device and on the CPU, on
     the same random inputs;
  3. reports `embed_norm` and the max |diff| of the feature map, the raw
     embedding and the rectified embedding between the two;
  4. with an aligned LFW tree, runs the verification protocol at ocl 0/1/2
     and reports (acc, acc_new), and with --int8 1 the int8-static
     deployment model on the same pairs against the 0.1% gate.

The `*_max_diff` keys are the card against the CPU: the kernels against
their plain twins, and cuDNN against the CPU's convolutions (TF32 off).
The JAX tool compares its JAX stack with the reference's PyTorch modules
under the same keys; that checkout is not part of this repository. With
--device cpu both sides would be the same computation, so the keys give
way to "torch_comparison": "skipped (...)".

    python -m ffrnet_torch.tools.parity_check --encoder se50.pth \
        [--recnet FFRNet.pth] [--lfw_root DIR --pairs lfw_pairs.txt]
        [--int8 1] [--device cuda]

Prints the report as indented JSON and returns it as a dict.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def load_model(encoder_path, recnet_path, device):
    """The released weights as an fp32 FFRNet with BN unfolded on `device`
    (on the card TF32 is switched off). Without `recnet_path`, RecNet is
    random (generator seed 0)."""
    from ffrnet_torch.api import FFRNet

    return FFRNet.from_pretrained(encoder_path, recnet_path, fold_bn=False, device=device)


def inputs(n: int = 4, seed: int = 0) -> np.ndarray:
    """(n, 3, 112, 112) float32 uniform [-1, 1] NCHW images, default_rng(seed)."""
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3, 112, 112)).astype(np.float32)


def outputs(model, x: np.ndarray, with_recnet: bool):
    """(feature map (N, 512, 7, 7), raw embedding, rectified embedding or
    None) of NCHW images on the model's device, as CPU tensors."""
    with torch.inference_mode():
        featmap, embed = model.encoder(torch.from_numpy(x).to(model.device))
        rect = model.recnet(featmap)[0] if with_recnet else None
    return tuple(None if t is None else t.float().cpu() for t in (featmap, embed, rect))


def compare_with_torch(encoder_path, recnet_path, n: int = 4, seed: int = 0, device="cuda"):
    from ffrnet_torch.api import resolve_device

    dev = resolve_device(device)
    x = inputs(n, seed)
    model = load_model(encoder_path, recnet_path, dev)
    featmap, embed, rect = outputs(model, x, bool(recnet_path))
    report = {"embed_norm": float(torch.linalg.norm(embed[0]))}
    if dev.type == "cpu":
        report["torch_comparison"] = ("skipped (--device cpu: the CPU run is the reference; "
                                      "pass --device cuda to hold the card against it)")
        return report
    ref = outputs(load_model(encoder_path, recnet_path, "cpu"), x, bool(recnet_path))
    for key, got, want in zip(("featmap_max_diff", "embed_max_diff", "rectified_max_diff"),
                              (featmap, embed, rect), ref):
        if got is not None:
            report[key] = float((got - want).abs().max())
    return report


def quantize_for_deployment(model, cal_images, dtype_name: str = "bf16"):
    """The int8-static deployment model from imported float weights: BN
    folded, cast to the compute type, int8 sites in the encoder and RecNet,
    static activation scales calibrated on `cal_images` ((K, 112, 112, 3)
    [-1, 1] float BGR)."""
    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    return model.prepare(fold_bn=True, dtype=dtype, quantize_int8="all").calibrate_int8(
        [np.asarray(cal_images, np.float32)])


def run_lfw(encoder_path, recnet_path, lfw_root, pairs, batch_size=64, int8=False,
            cal_images=8, device="cuda"):
    from ffrnet_torch.data.datasets import LfwPairs
    from ffrnet_torch.data.pipeline import BatchLoader
    from ffrnet_torch.eval.runner import evaluate_pairs

    model = load_model(encoder_path, recnet_path, device)
    q_model = None
    out = {}
    for ocl in (0, 1, 2):
        ds = LfwPairs(lfw_root, pairs, test_ocl_num=ocl, flip_prob=0.0)
        loader = BatchLoader(ds, batch_size, shuffle=False, drop_last=False)
        res_new, res_raw = evaluate_pairs(model.pair_scores, loader.epoch(0))
        out[f"ocl{ocl}"] = {"acc_new": float(res_new.mean_accuracy),
                            "acc": float(res_raw.mean_accuracy)}
        if int8:
            # the int8-static deployment arm on the SAME pairs, calibrated
            # on the first pairs' img1 of ocl 0
            if q_model is None:
                cal = [ds.get(i, np.random.default_rng(0))["img1"]
                       for i in range(min(cal_images, len(ds)))]
                q_model = quantize_for_deployment(model, np.stack(cal))
            rq_new, rq_raw = evaluate_pairs(q_model.pair_scores, loader.epoch(0))
            cell = out[f"ocl{ocl}"]
            cell["acc_new_int8"] = float(rq_new.mean_accuracy)
            cell["acc_int8"] = float(rq_raw.mean_accuracy)
            cell["d_int8"], cell["int8_within_0.1pct"] = int8_gate(
                cell["acc_new"], cell["acc"], cell["acc_new_int8"], cell["acc_int8"])
    return out


def int8_gate(acc_new, acc, acc_new_int8, acc_int8, budget=0.001):
    """-> (display_deltas, within_budget) for the int8 acceptance gate.

    The flag is computed from the unrounded deltas: a true delta of
    0.00104 must fail the 0.1% budget even though it displays as 0.001.
    Rounding is display-only."""
    d_exact = [acc_new_int8 - acc_new, acc_int8 - acc]
    return ([round(d, 4) for d in d_exact],
            bool(max(abs(d) for d in d_exact) <= budget))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--encoder", required=True)
    p.add_argument("--recnet", default="")
    p.add_argument("--lfw_root", default="")
    p.add_argument("--pairs", default="")
    p.add_argument("--int8", type=int, default=0,
                   help="also gate the int8-static deployment model: same ocl 0/1/2 "
                        "protocol, per-ocl deltas vs float, 0.1%% acceptance flag")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ffrnet_torch.api import resolve_device

    dev = resolve_device(args.device)
    report = compare_with_torch(args.encoder, args.recnet, device=dev)
    if args.lfw_root and args.pairs:
        report["lfw"] = run_lfw(args.encoder, args.recnet, args.lfw_root, args.pairs,
                                int8=bool(args.int8), device=dev)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
