"""Driver-loop throughput (ffrnet_tpu/tools/bench_driver.py): loader
threads -> upload to the device -> train_step -> metrics fetched once at
the end, i.e. what train.py does per iteration, including the host ->
device input traffic that bench_train's pre-staged batch leaves out.

SyntheticPairs makes the samples on the fly (no disk, no decode), so the
loop measures the loader's assembly and upload and the step. The loader
uploads each batch from pinned memory on its own CUDA stream in its
producer thread (data/pipeline.py), so the next batch crosses while the
current step runs. --host_normalize 0 ships uint8 (4x fewer bytes) and
normalizes on the device; --upload_only 1 skips the step; --pack 1 stacks
both image streams into one (N, 2, 112, 112, 3) buffer per batch.

Two flags of the JAX tool have no counterpart here: --donate (torch.optim
updates the parameters in place, so there is no buffer to donate) and
--producer_upload (the loader always uploads in its producer thread).

    python -m ffrnet_torch.tools.bench_driver [--batch 128] [--iters 30]
        [--host_normalize 0|1] [--upload_only 0|1] [--pack 0|1]
        [--dtype fp32|bf16] [--device cuda]

Random weights (encoder seed 0, RecNet seed 1), Adam lr 1e-3. The first
batch and --warmup more run before the clock starts; the clock is the host
clock from there to the last step's metrics on the host. Prints one JSON
line (the JAX tool's keys, less donate and producer_upload) and returns it
as a dict.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--host_normalize", type=int, default=0)
    p.add_argument("--num_classes", type=int, default=64)
    p.add_argument("--dtype", type=str, default="fp32", choices=["fp32", "bf16"])
    p.add_argument("--n_thread", type=int, default=8)
    p.add_argument("--upload_only", type=int, default=0,
                   help="skip the train step: the loader and upload alone")
    p.add_argument("--pack", type=int, default=0,
                   help="one (N, 2, H, W, C) buffer per batch for both image streams")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ffrnet_torch.api import resolve_device
    from ffrnet_torch.data.datasets import SyntheticPairs
    from ffrnet_torch.data.pipeline import BatchLoader
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.models.recnet import RecNetConfig
    from ffrnet_torch.training.trainer import (TrainerConfig, create_train_state, half_dtype,
                                               train_step)

    dev = resolve_device(args.device)
    cfg = TrainerConfig(optimizer="adam", lr=1e-3, compute_dtype=args.dtype,
                        recnet=RecNetConfig(num_classes=args.num_classes))
    encoder = build_backbone(generator=torch.Generator().manual_seed(0), device=dev)
    encoder = encoder.to(half_dtype(args.dtype) or torch.float32)
    state = create_train_state(cfg, seed=1, device=dev)
    ds = SyntheticPairs(num_identities=args.num_classes,
                        samples_per_id=max(1, (args.iters + args.warmup + 2) * args.batch
                                           // args.num_classes + 1),
                        host_normalize=bool(args.host_normalize))
    pack = {"imgs": ("img_non", "img_ocl")} if args.pack else None
    loader = BatchLoader(ds, args.batch, shuffle=False, drop_last=True, seed=0,
                         num_threads=args.n_thread, process_index=0, process_count=1,
                         device=dev, pack=pack)
    sample = ds.get(0, np.random.default_rng(0))
    bytes_per_batch = 2 * args.batch * sample["img_non"].nbytes

    def wait(batch):
        # a one-element copy to the host waits for the batch's upload
        batch["label"][:1].cpu()

    it = iter(loader.epoch(0))
    batch = next(it)
    if not args.upload_only:
        state, metrics = train_step(encoder, state, batch, cfg=cfg)
        float(metrics["TotalLoss"])
    for _ in range(args.warmup):
        batch = next(it)
        if args.upload_only:
            wait(batch)
        else:
            state, metrics = train_step(encoder, state, batch, cfg=cfg)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    pending = []
    t0 = time.perf_counter()
    for _ in range(args.iters):
        batch = next(it)
        if args.upload_only:
            wait(batch)
        else:
            state, metrics = train_step(encoder, state, batch, cfg=cfg)
            pending.append(metrics["TotalLoss"])
    if pending:
        torch.stack(pending).cpu()  # the lazy metrics, fetched once
    dt = time.perf_counter() - t0
    it.close()
    out = {
        "metric": "driver_loop_imgs_per_sec",
        "value": round(args.batch * args.iters / dt, 2),
        "unit": "imgs/s",
        "ms_per_iter": round(1e3 * dt / args.iters, 2),
        "batch": args.batch,
        "host_normalize": bool(args.host_normalize),
        "upload_only": bool(args.upload_only),
        "mb_per_batch": round(bytes_per_batch / 1e6, 2),
        "dtype": args.dtype,
        "pack": bool(args.pack),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
