"""Where an `embed` spends the card's time: kernel time by group, and the
device's busy and idle share, from a torch.profiler trace.

    python3 -m ffrnet_torch.tools.profile_embed

Needs an NVIDIA GPU. Profiles 3 embeds of N=256 uint8 faces already on the
card (after 2 warm-up) for each of fused fp32, fused bf16 and ss_kernel
fp32. Prints, per run, one line per kernel group (sorted by time) with the
kernels that make up the group, and a JSON summary with the card's name and
power limit.
"""

from __future__ import annotations

import json
import re
import subprocess
import time

import torch

N, ITERS = 256, 3
RUNS = (("fused", "fp32"), ("fused", "bf16"), ("ss_kernel", "fp32"))

# kernel-name patterns -> group; the first match wins. cuDNN's layout
# kernels (cudnn::ops::nchwToNhwcKernel) go before the convolutions, and
# the convolutions before cuBLAS's GEMMs, whose names also hold "gemm".
# A convolution is an implicit GEMM (fprop) or an FFT one: fft2d_r2c, a
# complex-fp32 GEMM (xmma_gemm_cf32...), fft2d_c2r; the model has no other
# complex product
GROUPS = (
    ("se_gating", r"se_(pool|gate|scale)_kernel"),
    ("self_similarity", r"ss_(space|channel)_kernel"),
    ("channel_branch", r"cb_(prep|rows)_kernel"),
    ("layout (NCHW<->NHWC)", r"nchwToNhwc|nhwcToNchw"),
    ("conv (cuDNN)", r"fprop|dgrad|wgrad|implicit|convolve|conv|winograd|fft|flip_filter|"
                     r"cudnn|gemm_cf32|cgemm"),
    ("gemm (cuBLAS)", r"gemm|gemv|cutlass|splitK"),
    ("reduce", r"reduce"),
    ("copy / pad / cat", r"copy|transpose|cat|pad|flip|memcpy|memset"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)


def group_of(name: str) -> str:
    for group, pat in GROUPS:
        if re.search(pat, name, re.I):
            return group
    return "other"


def busy_us(intervals):
    """Length of the union of [start, end) intervals, in microseconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile(config: str, dtype_name: str, card: str) -> dict:
    from ffrnet_torch.api import FFRNet
    from ffrnet_torch.models.recnet import SS_KERNEL_CONFIG, RecNetConfig

    cfg = SS_KERNEL_CONFIG if config == "ss_kernel" else RecNetConfig()
    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    model = FFRNet.random(seed=0, cfg=cfg, dtype=dtype, device="cuda")
    faces = torch.randint(0, 256, (N, 112, 112, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(0)).cuda()
    for _ in range(2):
        model.embed(faces)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            model.embed(faces)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("profile_embed: the trace holds no device events")
    by_group, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        g = group_of(e.name)
        by_group[g] = by_group.get(g, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    label = f"{config} {dtype_name} N={N}"
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label} {g}: {us / ITERS / 1e3:.3f} ms/embed "
              f"({100 * us / busy:.1f}% of busy)")
        members = sorted(((u, n) for n, u in by_name.items() if group_of(n) == g),
                         reverse=True)
        for u, name in members[:4]:
            print(f"[profile]     {u / ITERS / 1e3:.3f} ms {name[:120]}")
    summary = {
        "config": config, "dtype": dtype_name, "n": N, "card": card,
        "wall_ms_per_embed": wall_us / ITERS / 1e3,
        "device_busy_ms_per_embed": busy / ITERS / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "kernels_per_embed": len(kernels) / ITERS,
        "group_ms_per_embed": {g: us / ITERS / 1e3 for g, us in by_group.items()}}
    print(json.dumps(summary), flush=True)
    return summary


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    for config, dtype_name in RUNS:
        profile(config, dtype_name, card)


if __name__ == "__main__":
    main()
