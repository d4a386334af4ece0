"""Train-step throughput on one card (counterpart of
ffrnet_tpu/tools/bench_train.py).

    python -m ffrnet_torch.tools.bench_train [--batch 128] [--iters 10]
        [--optimizer adam] [--num_classes 10575] [--dtype fp32|bf16]
        [--remat 0|1] [--remat_channel 0|1] [--ss_loss_impl factored]
        [--c4c_impl factored] [--features 0|1]
        [--enc_arms 0|1] [--rounds 3] [--converge N] [--device cuda]

The full step (train_step: one 2N frozen IR-SE50 pass, RecNet forward on
both branches, the four-part loss, backward, clip and update) or, with
--features 1, the RecNet-only step from features encoded once
(train_step_from_features). Random weights (encoder seed 0, RecNet seed 1)
and a random [-1, 1] batch already on the device. Each step is timed with
CUDA events; after 3 warm-up steps, the median of --iters (at least 10)
steps. Prints one JSON line with train_imgs_per_sec_per_chip (images of
the batch per second, as the JAX tool counts them), step_ms, the spread,
and the card's name and power limit.

--enc_arms 1 duels the frozen encoder inside the full step instead
(`encoder_arms`): `float` (the trainer's encoder), `folded`
(`fold_backbone_bn`: exact, since the frozen encoder runs in eval mode and
no gradient reaches it) and `int8_static` (folded, cast, `quantize_encoder`,
static scales through `tools/int8_cache.py` keyed by the weights'
fingerprint, in `.int8_scales_torch.json`). Each arm has its own
TrainState; after 3 warm-up steps of each arm, --rounds rounds run every
arm's --iters steps in turn (`interleaved_rounds`), each round giving its
median; an arm's step_ms is its best round. Prints the JAX tool's record
("tool": "bench_train_enc_arms", step_ms_*, imgs_per_sec_*, speedup_*)
with every round's median, the card's name and power limit. The JAX
tool's chained-slope timing worked around its relay; CUDA events need no
such thing. --converge N adds N Adam steps (lr 1e-3, min(num_classes, 64)
classes) per arm, float and int8_static, on the JAX tool's SyntheticPairs
batches (`converge_batches`), and prints "bench_train_enc_arms_converge"
with each arm's last TrainAcc, triplet_gap (NegDist - PosDist) and
TotalLoss.

--device cpu runs the plain versions for the tests; its times are the
host clock's and say nothing of a card. The default is the card, and
without one the tool raises.

main returns the records it printed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ffrnet_torch.models.recnet import RecNetConfig
from ffrnet_torch.training.trainer import (TrainerConfig, create_train_state, encode_frozen,
                                           half_dtype, train_step, train_step_from_features)

WARMUP = 3
ARMS = ("float", "folded", "int8_static")
CONVERGE_ARMS = ("float", "int8_static")


def step_times(step, iters: int, warmup: int = WARMUP, device=None):
    """(milliseconds of each of `iters` calls of `step` after `warmup`
    calls, the last call's metrics): on the card CUDA events around each
    call, which waits for its end before the next starts; on the CPU
    (`device` of type cpu) the host clock."""
    for _ in range(warmup):
        step()
    if device is not None and device.type != "cuda":
        ms = []
        for _ in range(iters):
            t0 = time.perf_counter()
            _, metrics = step()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms, metrics
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


def encoder_arms(encoder, dtype_name: str, *, cache_file: str):
    """-> ({arm: encoder in the compute type}, scale-cache status) from the
    fp32 float `encoder` (left as it is): `float` a cast copy, `folded` its
    BN fold, `int8_static` the fold's int8 sites with static scales."""
    import copy

    from ffrnet_torch.models.optimize import fold_backbone_bn
    from ffrnet_torch.models.quantize import quantize_encoder
    from ffrnet_torch.tools import int8_cache

    dtype = half_dtype(dtype_name) or torch.float32
    folded = fold_backbone_bn(encoder).to(dtype)
    qmodel = quantize_encoder(folded)
    static, status = int8_cache.static_encoder_tree(
        qmodel, dtype, cache_file=cache_file,
        cache_key=int8_cache.encoder_cache_key(qmodel, dtype_name=dtype_name))
    return {"float": copy.deepcopy(encoder).to(dtype), "folded": folded,
            "int8_static": static}, status


def interleaved_rounds(steps, rounds: int, iters: int, *, device, warmup: int = WARMUP):
    """({arm: [median ms of each round]}, {arm: its last step's metrics}):
    `warmup` calls of each arm's step, then `rounds` rounds that each run
    every arm's `iters` timed calls in turn."""
    for step in steps.values():
        for _ in range(warmup):
            step()
    ms, metrics = {k: [] for k in steps}, {}
    for _ in range(rounds):
        for k, step in steps.items():
            t, metrics[k] = step_times(step, iters, warmup=0, device=device)
            ms[k].append(float(np.median(t)))
    return ms, metrics


def card_info(device):
    """(device name, nvidia-smi's "name, power.limit" line or None)."""
    if device.type != "cuda":
        return "cpu", None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    return torch.cuda.get_device_name(device), smi[0] if smi else None


def enc_arms_record(round_ms, *, batch: int, dtype: str, scale_cache: str, iters: int, device):
    """The JAX tool's record of the duel (ffrnet_tpu/tools/bench_train.py:
    136-146) from each arm's round medians, unrounded, with the spread
    (round_ms_*), the steps timed a round and the device."""
    rec = {"tool": "bench_train_enc_arms", "batch": batch, "dtype": dtype,
           "scale_cache": scale_cache}
    for k, v in round_ms.items():
        rec[f"step_ms_{k}"] = min(v)
        rec[f"imgs_per_sec_{k}"] = batch / min(v) * 1e3
    for k in ("folded", "int8_static"):
        rec[f"speedup_{k}"] = rec["step_ms_float"] / rec[f"step_ms_{k}"]
    for k, v in round_ms.items():
        rec[f"round_ms_{k}"] = v
    rec["steps_timed"] = iters
    rec["device"], rec["nvidia_smi"] = card_info(device)
    return rec


def converge_batches(dataset, batch: int, steps: int):
    """The JAX tool's batches (ffrnet_tpu/tools/bench_train.py:166-172):
    indices with replacement from default_rng(1), samples drawn with
    default_rng(2), both fresh for each arm; NHWC numpy arrays."""
    order, srng = np.random.default_rng(1), np.random.default_rng(2)
    for _ in range(steps):
        idx = order.choice(len(dataset), batch, replace=True)
        samples = [dataset.get(int(i), srng) for i in idx]
        yield {k: np.stack([s[k] for s in samples]) for k in ("img_non", "img_ocl", "label")}


def converge(arms, steps: int, *, batch: int, num_classes: int, dtype: str, device):
    """N Adam steps of a fresh TrainState (RecNet seed 1) per arm of
    CONVERGE_ARMS on the same batches -> the JAX tool's converge record."""
    from ffrnet_torch.data.datasets import SyntheticPairs

    n_ids = min(num_classes, 64)
    ds = SyntheticPairs(num_identities=n_ids, samples_per_id=4, seed=3)
    cfg = TrainerConfig(optimizer="adam", lr=1e-3, compute_dtype=dtype,
                        recnet=RecNetConfig(num_classes=n_ids))
    out = {}
    for k in CONVERGE_ARMS:
        state = create_train_state(cfg, seed=1, device=device)
        for b in converge_batches(ds, batch, steps):
            state, m = train_step(arms[k], state, b, cfg=cfg)
        out[k] = {"TrainAcc": float(m["TrainAcc"]),
                  "triplet_gap": float(m["NegDist"]) - float(m["PosDist"]),
                  "TotalLoss": float(m["TotalLoss"])}
    return {"tool": "bench_train_enc_arms_converge", "steps": steps, "batch": batch,
            "num_classes": n_ids, "dtype": dtype, "arms": out}


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
    p.add_argument("--enc_arms", type=int, default=0,
                   help="duel the frozen encoder inside the full step: float, BN-folded and "
                        "int8-static, in interleaved rounds; overrides --features")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--converge", type=int, default=0,
                   help="with --enc_arms: also N Adam steps per arm (float, int8_static) on "
                        "the same synthetic identities; final TrainAcc, triplet gap, loss")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.iters < 10:
        p.error("--iters must be at least 10")
    if args.rounds < 1:
        p.error("--rounds must be at least 1")

    from ffrnet_torch.api import resolve_device
    from ffrnet_torch.models.irse import build_backbone

    dev = resolve_device(args.device)
    cfg = TrainerConfig(optimizer=args.optimizer, lr=1e-3, compute_dtype=args.dtype,
                        remat=bool(args.remat), ss_loss_impl=args.ss_loss_impl,
                        recnet=RecNetConfig(num_classes=args.num_classes, c4c_impl=args.c4c_impl,
                                            remat_channel=bool(args.remat_channel)))
    encoder = build_backbone(generator=torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator().manual_seed(0)
    batch = {"img_non": (torch.rand(args.batch, 112, 112, 3, generator=g) * 2 - 1).to(dev),
             "img_ocl": (torch.rand(args.batch, 112, 112, 3, generator=g) * 2 - 1).to(dev),
             "label": torch.randint(0, args.num_classes, (args.batch,), generator=g).to(dev)}

    if args.enc_arms:
        from ffrnet_torch.tools import int8_cache

        arms, status = encoder_arms(encoder, args.dtype,
                                    cache_file=int8_cache.default_cache_file())
        states = {k: create_train_state(cfg, seed=1, device=dev) for k in arms}
        steps = {k: (lambda k=k: train_step(arms[k], states[k], batch, cfg=cfg)) for k in arms}
        round_ms, metrics = interleaved_rounds(steps, args.rounds, args.iters, device=dev)
        for k, m in metrics.items():
            if not np.isfinite(float(m["TotalLoss"])):
                raise SystemExit(f"bench_train: arm {k}: non-finite loss {float(m['TotalLoss'])}")
        records = [enc_arms_record(round_ms, batch=args.batch, dtype=args.dtype,
                                   scale_cache=status, iters=args.iters, device=dev)]
        print(json.dumps(records[0]), flush=True)
        if args.converge:
            records.append(converge(arms, args.converge, batch=args.batch,
                                    num_classes=args.num_classes, dtype=args.dtype, device=dev))
            print(json.dumps(records[1]), flush=True)
        return records

    state = create_train_state(cfg, seed=1, device=dev)
    if args.dtype == "bf16":
        encoder = encoder.to(torch.bfloat16)
    if args.features:
        feats = encode_frozen(encoder, batch)

        def step():
            return train_step_from_features(state, feats, cfg=cfg)
    else:
        def step():
            return train_step(encoder, state, batch, cfg=cfg)

    ms, metrics = step_times(step, args.iters, device=dev)
    loss = float(metrics["TotalLoss"])
    if not np.isfinite(loss):
        raise SystemExit(f"bench_train: non-finite loss {loss}")
    name, smi = card_info(dev)
    step_ms = float(np.median(ms))
    rec = {
        "metric": "train_imgs_per_sec_per_chip",
        "value": args.batch / step_ms * 1e3,
        "unit": "imgs/s",
        "step_ms": step_ms,
        "step_ms_min": min(ms), "step_ms_max": max(ms), "steps_timed": len(ms),
        "batch": args.batch, "dtype": args.dtype, "optimizer": args.optimizer,
        "num_classes": args.num_classes, "remat": bool(args.remat),
        "remat_channel": bool(args.remat_channel), "ss_loss_impl": args.ss_loss_impl,
        "c4c_impl": args.c4c_impl, "features": bool(args.features),
        "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda"
                         else None),
        "device": name, "nvidia_smi": smi,
        "total_loss": loss,
    }
    print(json.dumps(rec))
    return [rec]


if __name__ == "__main__":
    main()
