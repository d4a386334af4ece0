"""Feature-cache build pass: the float against the int8-static frozen
encoder (ffrnet_tpu/tools/bench_cache_build.py).

Measures what `--cache_features 1 --int8_encoder 1` buys: the one-time
cache build (`training/feature_cache.py::build_feature_cache`) is a full
frozen-encoder sweep over every (sample, flip), so the int8 encoder's
speed applies to the whole pass. The int8 arm is
`train.py::prepare_int8_encoder` (BN folded, cast, int8 sites, static
scales calibrated on 8 training images), which runs once before the timing
and is reported as its own one-time cost (`calibration_s_onetime`); it
reaches the build as the driver passes it, through `encoder_factory`, with
the driver's `fingerprint_extra`.

Each arm gets one untimed warm build, then rounds interleave (float, int8,
float, int8, ...), each into a fresh cache directory. The host clock times
each build end to end: the loader's host synthesis of the samples, their
upload, the encoder forwards, the features' copy back and the host writes.
So the speedup is that of the whole pass, not of the encoder alone: a
build bound by the host synthesis of `SyntheticPairs` shows a speedup
near 1 whatever the encoder does.

    python -m ffrnet_torch.tools.bench_cache_build [--n 2048] [--batch 256]
        [--dtype bf16] [--rounds 3] [--device cuda]

Prints one JSON line (the JAX tool's keys) and returns it as a dict.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np
import torch


def make_dataset(n: int, num_identities: int = 64):
    """SyntheticPairs of about `n` samples (at least one per identity)."""
    from ffrnet_torch.data.datasets import SyntheticPairs

    return SyntheticPairs(num_identities=num_identities,
                          samples_per_id=max(1, n // num_identities), seed=0)


def make_arms(dataset, dtype_name: str, device):
    """-> (the fp32 float encoder (generator seed 0) on `device`, {arm:
    build_feature_cache keywords}, the int8 arm's calibration seconds). On
    the card TF32 is switched off, as the driver's `train.load_encoder`
    does."""
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.train import INT8_CACHE_TAG, prepare_int8_encoder

    enc = build_backbone(generator=torch.Generator().manual_seed(0), device=device)
    if enc.input_layer[0].weight.device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    q_enc = prepare_int8_encoder(enc, dataset, dtype_name)
    if q_enc.input_layer[0].weight.device.type == "cuda":
        torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    arms = {"float": {},
            "int8": {"encoder_factory": lambda: q_enc, "fingerprint_extra": INT8_CACHE_TAG}}
    return enc, arms, cal_s


def one_build(dataset, encoder, arm, *, batch: int, dtype_name: str, cache_dir=None) -> float:
    """Host seconds of one `build_feature_cache` of `dataset` with the
    arm's keywords, into `cache_dir` (kept), or into a fresh temporary
    directory removed after."""
    from ffrnet_torch.training.feature_cache import build_feature_cache

    d = cache_dir or tempfile.mkdtemp(prefix="ffrnet_cachebuild_")
    try:
        t0 = time.perf_counter()
        build_feature_cache(dataset, encoder, d, batch_size=batch, compute_dtype=dtype_name,
                            num_threads=2, **arm)
        return time.perf_counter() - t0
    finally:
        if cache_dir is None:
            shutil.rmtree(d, ignore_errors=True)


def run_rounds(dataset, encoder, arms, *, batch: int, dtype_name: str, rounds: int):
    """One untimed warm build per arm, then `rounds` interleaved rounds ->
    {arm: [seconds of each round]}."""
    n = len(dataset)
    for name, arm in arms.items():
        w = one_build(dataset, encoder, arm, batch=batch, dtype_name=dtype_name)
        print(f"[warm] {name}: {w:.2f}s", file=sys.stderr, flush=True)
    times = {k: [] for k in arms}
    for r in range(rounds):
        for name, arm in arms.items():
            dt = one_build(dataset, encoder, arm, batch=batch, dtype_name=dtype_name)
            times[name].append(dt)
            print(f"[round {r}] {name}: {dt:.3f}s ({n / dt:.1f} samples/s)", file=sys.stderr,
                  flush=True)
    return times


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=2048,
                   help="dataset size (samples; each builds 2 flip variants)")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--dtype", type=str, default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--rounds", type=int, default=3, help="interleaved (float, int8) rounds")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ffrnet_torch.api import resolve_device

    dev = resolve_device(args.device)
    ds = make_dataset(args.n)
    n = len(ds)
    enc, arms, cal_s = make_arms(ds, args.dtype, dev)
    times = run_rounds(ds, enc, arms, batch=args.batch, dtype_name=args.dtype,
                       rounds=args.rounds)
    med = {k: float(np.median(v)) for k, v in times.items()}
    out = {
        "tool": "bench_cache_build",
        "n": n, "batch": args.batch, "dtype": args.dtype,
        "calibration_s_onetime": round(cal_s, 2),
        "pass_s": {k: [round(t, 3) for t in v] for k, v in times.items()},
        "median_s": {k: round(v, 3) for k, v in med.items()},
        "samples_per_s": {k: round(n / v, 1) for k, v in med.items()},
        "speedup_int8": round(med["float"] / med["int8"], 3),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
