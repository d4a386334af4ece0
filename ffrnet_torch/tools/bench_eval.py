"""Full-LFW-pass evaluation benchmark (ffrnet_tpu/tools/bench_eval.py).

Times the complete verification protocol: --pairs pairs through the
frozen IR-SE50 + RecNet (random weights, seeds 0 and 1, the fused RecNet
configuration), raw and rectified cosine scores, the 10-fold threshold
sweep, exactly as eval/runner.py::evaluate_pairs runs it in the driver's
eval and test phase. The runner keeps every batch's scores on the device
and waits for it once per pass; --sync_per_batch moves each batch's scores
to the host inside the loop (the reference's per-batch round trip,
lfw/lfw_eval.py:226-252), and the sweep then runs on the host copies.

The pairs are staged on the device in the compute type before the clock
starts (labels stay host arrays), which leaves out host synthesis and
upload. A pass is timed on the host clock and ends in
torch.cuda.synchronize(); the first pass is reported apart on stderr.

    python -m ffrnet_torch.tools.bench_eval [--batch 250] [--pairs 6000]
        [--dtype bf16] [--repeats 3] [--sync_per_batch] [--device cuda]

Prints one JSON line (the JAX tool's keys) and returns it as a dict.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def stage_pairs(n: int, batch: int, dtype, device, seed: int = 0):
    """{'img1', 'img2', 'label'} batches of `batch` pairs (the last may be
    smaller): [-1, 1] NHWC images on `device` in `dtype`, labels host int64;
    the JAX tool's numpy stream."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(0, n, batch):
        b = min(batch, n - i)
        out.append({
            "img1": torch.from_numpy(rng.uniform(-1, 1, (b, 112, 112, 3)).astype(
                np.float32)).to(device=device, dtype=dtype),
            "img2": torch.from_numpy(rng.uniform(-1, 1, (b, 112, 112, 3)).astype(
                np.float32)).to(device=device, dtype=dtype),
            "label": rng.integers(0, 2, b).astype(np.int64),
        })
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=250)
    p.add_argument("--pairs", type=int, default=6000)
    p.add_argument("--dtype", type=str, default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--sync_per_batch", action="store_true",
                   help="move each batch's scores to the host inside the loop")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ffrnet_torch.api import FFRNet, resolve_device
    from ffrnet_torch.eval.runner import evaluate_pairs, make_pair_score_fn

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model = FFRNet.random(0, device=dev, dtype=dtype)
    batches = stage_pairs(args.pairs, args.batch, dtype, dev)

    base_score = make_pair_score_fn(model.encoder, model.recnet)
    if args.sync_per_batch:
        def score(img1, img2):
            r, s = base_score(img1, img2)
            return r.cpu(), s.cpu()  # a host sync per batch
    else:
        score = base_score

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def one_pass():
        sync()
        t0 = time.perf_counter()
        res_new, res_raw = evaluate_pairs(score, batches)
        # evaluate_pairs copied the results to the host; reading them is free
        float(res_new.mean_accuracy), float(res_raw.mean_accuracy)
        sync()
        return time.perf_counter() - t0

    t_first = one_pass()
    print(f"[bench_eval] first pass {t_first:.1f}s", file=sys.stderr, flush=True)
    times = [one_pass() for _ in range(args.repeats)]
    best = min(times)
    out = {
        "metric": "lfw_eval_pass_seconds",
        "value": round(best, 3),
        "unit": "s",
        "pairs": args.pairs,
        "batch": args.batch,
        "dtype": args.dtype,
        "sync_per_batch": bool(args.sync_per_batch),
        "pairs_per_sec": round(args.pairs / best, 1),
        "all_times": [round(t, 3) for t in times],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
