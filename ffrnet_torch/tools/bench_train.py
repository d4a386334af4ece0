"""Train-step throughput on one card (counterpart of
ffrnet_tpu/tools/bench_train.py).

    python -m ffrnet_torch.tools.bench_train [--batch 128] [--iters 10]
        [--optimizer adam] [--num_classes 10575] [--dtype fp32|bf16]
        [--remat 0|1] [--remat_channel 0|1] [--ss_loss_impl factored]
        [--c4c_impl factored] [--features 0|1]

The full step (train_step: one 2N frozen IR-SE50 pass, RecNet forward on
both branches, the four-part loss, backward, clip and update) or, with
--features 1, the RecNet-only step from features encoded once
(train_step_from_features). Random weights (encoder seed 0, RecNet seed 1)
and a random [-1, 1] batch already on the card. Each step is timed with
CUDA events; after 3 warm-up steps, the median of --iters (at least 10)
steps. Prints one JSON line with train_imgs_per_sec_per_chip (images of
the batch per second, as the JAX tool counts them), step_ms, the spread,
and the card's name and power limit. Needs a card: there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

WARMUP = 3


def step_times(step, iters: int, warmup: int = WARMUP):
    """(milliseconds of each of `iters` calls of `step` after `warmup`
    calls, the last call's metrics): CUDA events around each call, which
    waits for its end before the next starts."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    ms = []
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        start.record()
        _, metrics = step()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return ms, metrics


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--optimizer", type=str, default="adam")
    p.add_argument("--num_classes", type=int, default=10575)
    p.add_argument("--dtype", type=str, default="fp32", choices=["fp32", "bf16"])
    p.add_argument("--remat", type=int, default=0)
    p.add_argument("--remat_channel", type=int, default=0)
    p.add_argument("--ss_loss_impl", type=str, default="factored",
                   choices=["factored", "materialized"])
    p.add_argument("--c4c_impl", type=str, default="factored",
                   choices=["factored", "materialized"])
    p.add_argument("--features", type=int, default=0,
                   help="time train_step_from_features on features encoded once")
    args = p.parse_args(argv)
    if args.iters < 10:
        p.error("--iters must be at least 10")
    if not torch.cuda.is_available():
        raise SystemExit("bench_train: needs an NVIDIA GPU (torch.cuda.is_available() is False)")

    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.models.recnet import RecNetConfig
    from ffrnet_torch.training.trainer import (TrainerConfig, create_train_state,
                                               encode_frozen, train_step,
                                               train_step_from_features)

    dev = torch.device("cuda")
    cfg = TrainerConfig(optimizer=args.optimizer, lr=1e-3, compute_dtype=args.dtype,
                        remat=bool(args.remat), ss_loss_impl=args.ss_loss_impl,
                        recnet=RecNetConfig(num_classes=args.num_classes, c4c_impl=args.c4c_impl,
                                            remat_channel=bool(args.remat_channel)))
    state = create_train_state(cfg, seed=1, device=dev)
    encoder = build_backbone(generator=torch.Generator().manual_seed(0), device=dev)
    if args.dtype == "bf16":
        encoder = encoder.to(torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    batch = {"img_non": (torch.rand(args.batch, 112, 112, 3, generator=g) * 2 - 1).to(dev),
             "img_ocl": (torch.rand(args.batch, 112, 112, 3, generator=g) * 2 - 1).to(dev),
             "label": torch.randint(0, args.num_classes, (args.batch,), generator=g).to(dev)}
    if args.features:
        feats = encode_frozen(encoder, batch)

        def step():
            return train_step_from_features(state, feats, cfg=cfg)
    else:
        def step():
            return train_step(encoder, state, batch, cfg=cfg)

    ms, metrics = step_times(step, args.iters)
    loss = float(metrics["TotalLoss"])
    if not np.isfinite(loss):
        raise SystemExit(f"bench_train: non-finite loss {loss}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    step_ms = float(np.median(ms))
    print(json.dumps({
        "metric": "train_imgs_per_sec_per_chip",
        "value": args.batch / step_ms * 1e3,
        "unit": "imgs/s",
        "step_ms": step_ms,
        "step_ms_min": min(ms), "step_ms_max": max(ms), "steps_timed": len(ms),
        "batch": args.batch, "dtype": args.dtype, "optimizer": args.optimizer,
        "num_classes": args.num_classes, "remat": bool(args.remat),
        "remat_channel": bool(args.remat_channel), "ss_loss_impl": args.ss_loss_impl,
        "c4c_impl": args.c4c_impl, "features": bool(args.features),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi[0] if smi else None,
        "total_loss": loss,
    }))


if __name__ == "__main__":
    sys.exit(main())
