"""Where a train step spends the card's time: kernel time by group, the
device's busy and idle share, and the kernels per step, from a
torch.profiler trace.

    python3 -m ffrnet_torch.tools.profile_train

Needs an NVIDIA GPU. At N=128, the 10575-class head and Adam, profiles 3
steps (after 2 warm-up) of train_step_from_features in the fused and
ss_kernel RecNet configurations and of train_step in the fused one, each
in fp32 and in bf16. Prints, per run, one line per kernel group (sorted by
time) with its largest kernels, and a JSON summary with the card's name and
power limit. The groups are profile_embed's, with torch.optim's foreach
kernels first.
"""

from __future__ import annotations

import json
import subprocess
import time
from dataclasses import replace

import torch

from ffrnet_torch.tools.profile_embed import busy_us, group_of

N, ITERS = 128, 3
RUNS = (("fused", "fp32", "features"), ("ss_kernel", "fp32", "features"),
        ("fused", "fp32", "images"), ("fused", "bf16", "features"),
        ("ss_kernel", "bf16", "features"), ("fused", "bf16", "images"))


def train_group(name: str) -> str:
    return "optimizer (foreach)" if "multi_tensor" in name else group_of(name)


def profile(config: str, dtype_name: str, entry: str, card: str) -> dict:
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.models.recnet import SS_KERNEL_CONFIG, RecNetConfig
    from ffrnet_torch.training.trainer import (TrainerConfig, create_train_state,
                                               encode_frozen, train_step,
                                               train_step_from_features)

    rec = SS_KERNEL_CONFIG if config == "ss_kernel" else RecNetConfig()
    cfg = TrainerConfig(optimizer="adam", lr=1e-3, compute_dtype=dtype_name,
                        recnet=replace(rec, num_classes=10575))
    state = create_train_state(cfg, seed=1, device="cuda")
    enc = build_backbone(generator=torch.Generator().manual_seed(0), device="cuda")
    if dtype_name == "bf16":
        enc = enc.to(torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    batch = {"img_non": (torch.rand(N, 112, 112, 3, generator=g) * 2 - 1).cuda(),
             "img_ocl": (torch.rand(N, 112, 112, 3, generator=g) * 2 - 1).cuda(),
             "label": torch.randint(0, 10575, (N,), generator=g).cuda()}
    if entry == "features":
        feats = encode_frozen(enc, batch)

        def step():
            return train_step_from_features(state, feats, cfg=cfg)
    else:
        def step():
            return train_step(enc, state, batch, cfg=cfg)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("profile_train: the trace holds no device events")
    by_group, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        grp = train_group(e.name)
        by_group[grp] = by_group.get(grp, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    what = "train_step_from_features" if entry == "features" else "train_step"
    label = f"{config} {dtype_name} {what} N={N}"
    for grp, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label} {grp}: {us / ITERS / 1e3:.3f} ms/step "
              f"({100 * us / busy:.1f}% of busy)")
        members = sorted(((u, n) for n, u in by_name.items() if train_group(n) == grp),
                         reverse=True)
        for u, name in members[:3]:
            print(f"[profile]     {u / ITERS / 1e3:.3f} ms {name[:120]}")
    summary = {
        "config": config, "dtype": dtype_name, "entry": what, "n": N, "card": card,
        "wall_ms_per_step": wall_us / ITERS / 1e3,
        "device_busy_ms_per_step": busy / ITERS / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "kernels_per_step": len(kernels) / ITERS,
        "group_ms_per_step": {k: us / ITERS / 1e3 for k, us in by_group.items()}}
    print(json.dumps(summary), flush=True)
    return summary


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    for run in RUNS:
        profile(*run, card)


if __name__ == "__main__":
    main()
