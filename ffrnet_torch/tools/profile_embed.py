"""Where an `embed` spends the card's time: kernel time by group, and the
device's busy and idle share, from a torch.profiler trace.

    python3 -m ffrnet_torch.tools.profile_embed

Needs an NVIDIA GPU. Profiles 3 embeds of N=256 uint8 faces already on the
card (after 2 warm-up) for each of fused and ss_kernel, in fp32 and in
bf16, and for the int8 encoder (bf16, BN folded, static scales calibrated
on 8 faces, the fused RecNet). Prints, per run, one line per kernel group
(sorted by time) with the kernels that make up the group, and a JSON
summary with the card's name and power limit.

In the int8 run the kernels that quantize each site's activation
(ops/quant.py::quantize_activation: aminmax on dynamic sites, divide,
round, clamp, cast to int8; then to_nhwc: permute, pad, copy) form their
own group, "int8 quantize": the kernels of the ops that ran under a
record_function range this tool opens around those two functions.
"""

from __future__ import annotations

import json
import re
import subprocess
import time

import torch

N, ITERS = 256, 3
RUNS = (("fused", "fp32"), ("fused", "bf16"), ("ss_kernel", "fp32"), ("ss_kernel", "bf16"),
        ("int8", "bf16"))
QUANTIZE = "int8 quantize"

# kernel-name patterns -> group; the first match wins. cuDNN's layout
# kernels (cudnn::ops::nchwToNhwcKernel) go before the convolutions, and
# the convolutions before cuBLAS's GEMMs, whose names also hold "gemm".
# A convolution is an implicit GEMM (fprop) or an FFT one: fft2d_r2c, a
# complex-fp32 GEMM (xmma_gemm_cf32...), fft2d_c2r; the model has no other
# complex product
GROUPS = (
    ("int8_conv", r"int8_conv_kernel"),
    ("se_gating", r"se_gate_cluster_kernel"),
    ("self_similarity", r"ss_gram_kernel"),
    ("channel_branch", r"cb_sigmoid_attention_kernel"),
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


def int8_model(dtype):
    """The int8 encoder arm of chip_smoke.py phase 11: BN folded, `dtype`,
    static scales from calibrate_int8 on 8 uint8 faces (seed 110)."""
    from ffrnet_torch.api import FFRNet

    cal = torch.randint(0, 256, (8, 112, 112, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(110)).numpy()
    base = FFRNet.random(seed=0, device="cuda")
    return base.prepare(fold_bn=True, dtype=dtype, quantize_int8="encoder").calibrate_int8([cal])


class quantize_range:
    """Within the block, ops/quant.py's quantize_activation and to_nhwc run
    inside a record_function range named QUANTIZE."""

    def __enter__(self):
        import ffrnet_torch.ops.quant as Q

        self.saved = Q.quantize_activation, Q.to_nhwc

        def ranged(fn):
            def call(*args, **kw):
                with torch.profiler.record_function(QUANTIZE):
                    return fn(*args, **kw)
            return call

        Q.quantize_activation, Q.to_nhwc = map(ranged, self.saved)
        return self

    def __exit__(self, *exc):
        import ffrnet_torch.ops.quant as Q

        Q.quantize_activation, Q.to_nhwc = self.saved


def under_quantize(op) -> bool:
    """Whether a CPU op ran under the QUANTIZE range."""
    while op is not None:
        if op.name == QUANTIZE:
            return True
        op = op.cpu_parent
    return False


def profile(config: str, dtype_name: str, card: str) -> dict:
    import contextlib

    from ffrnet_torch.api import FFRNet
    from ffrnet_torch.models.recnet import SS_KERNEL_CONFIG, RecNetConfig

    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    if config == "int8":
        model = int8_model(dtype)
    else:
        cfg = SS_KERNEL_CONFIG if config == "ss_kernel" else RecNetConfig()
        model = FFRNet.random(seed=0, cfg=cfg, dtype=dtype, device="cuda")
    faces = torch.randint(0, 256, (N, 112, 112, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(0)).cuda()
    for _ in range(2):
        model.embed(faces)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ranged = quantize_range() if config == "int8" else contextlib.nullcontext()
    with ranged, torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            model.embed(faces)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = list(prof.events())
    # device kernels (the range's own device-side span is no kernel)
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.name != QUANTIZE]
    if not kernels:
        raise SystemExit("profile_embed: the trace holds no device events")
    by_group, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        g = group_of(e.name)
        by_group[g] = by_group.get(g, 0.0) + us
        by_name[e.name, g] = by_name.get((e.name, g), 0.0) + us
    # the kernels each aten op launched (the profiler links them to the
    # innermost op, and again to bookkeeping events, which are skipped):
    # those of ops under the QUANTIZE range move to that group
    for op in events:
        if op.device_type == torch.autograd.DeviceType.CPU and op.kernels \
                and op.name.startswith("aten::") and under_quantize(op):
            for k in op.kernels:
                g = group_of(k.name)
                for key, d in ((g, -k.duration), (QUANTIZE, k.duration)):
                    by_group[key] = by_group.get(key, 0.0) + d
                    by_name[k.name, key] = by_name.get((k.name, key), 0.0) + d
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    label = f"{config} {dtype_name} N={N}"
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label} {g}: {us / ITERS / 1e3:.3f} ms/embed "
              f"({100 * us / busy:.1f}% of busy)")
        members = sorted(((u, n) for (n, gn), u in by_name.items() if gn == g), reverse=True)
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
