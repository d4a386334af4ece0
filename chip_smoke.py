"""Drive the PyTorch/H100 port's inference, ingest, training, serving,
export, data-parallel and model-axis paths, its model-zoo extras and float
tools, and its int8 tools, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without a result line:

  1. device   the card's name and power limit (fails without a card)
  2. build    the five kernel libraries from ffrnet_torch/csrc, one nvcc
              each for sm_90a, all at once
  3. kernels  each kernel vs its plain PyTorch version at the main path's
              shapes, N=64, fp32 (TF32 off) and bf16, with the tolerances;
              se_gating and channel_branch also at N=1 and 3, with an
              all-zero sample (se_gating on every cluster size its plans
              take, channel_branch also with saturated sigmoids and a batch
              x8); self_similarity at N=256 (also x100) and on every C of
              64, 192, 512 by HW of 16, 49, 64 by N of 1, 3, 64, with a zero
              sample and a zero channel row, ss_channel exactly symmetric;
              the two warps on 250x250x3 noise, to 112x112 and 112x96;
              int8_conv at every int8 site shape of IR-SE50 and RecNet, N=1,
              3 and 64, fp32 and bf16 outputs, with and without bias, to the
              bit; a zero map, operands at +-127 and a misaligned input
  4. main     FFRNet.random(seed=0) embed / verify / evaluate in both RecNet
              configurations (fused channel branch; self-similarity kernel),
              plus a BN-folded model; whole-path parity with the CPU
  5. ingest   FFRNet.embed_canvas (embed_files after the decode) on the
              golden fixture's face, 64 faces through the band kernel and 4
              extreme ones through the full kernel; crop 0 against the
              pinned crop, crops and embeddings against the CPU
  6. counts   the launch counts of the main and ingest paths' runs
  7. times    embed faces/s at N=256 (fp32, bf16), ingest faces/s, and each
              kernel's time beside its plain version, its bound and, for
              the warps, F.affine_grid + F.grid_sample, with CUDA events;
              se_gating's gates stage by stage and in bf16, and
              channel_branch and self_similarity in fp32 and bf16, from CUDA
              graphs beside their bounds (self_similarity also through the
              host); beside it, as a yardstick, torch.bmm for its unscaled
              channel Gram alone
  8. train    RecNet training at full width (IR-SE50 frozen, C=512, the
              10575-class head) in both RecNet configurations: each kernel
              Function's gradient (kernel forward, the plain twin's VJP)
              against autograd through the twin, fp32 and bf16, at
              (64, 512, 7, 7), the encoder's SE shapes and (64, 512, 49);
              one train_step at N=4 on the card against the CPU (fp32, TF32
              off, SGD); the launches of one train_step and of one
              train_step_from_features; the JAX package's convergence
              protocol (64 SyntheticPairs identities, Adam lr 1e-3, batch
              64, up to 300 steps); step ms and train imgs/s at N=128 in
              fp32 and bf16, train_step and train_step_from_features; the
              self_similarity Function's backward beside its forward
  9. driver   python -m ffrnet_torch.train's main from files on disk: a
              JPEG tree made here (64 identities x 4 faces with masked
              twins, a CASIA list, 600 LFW pairs); an fp32 run (10575
              classes, batch 64, 2 epochs = 8 steps, checkpoints and LFW
              eval at ocl 0/1/2 every 4), its resume from 0000004 in a fresh
              root, a bf16 --ss_impl pallas --cache_features 1 run, and
              --phase test --report_roc 1 --save_wrong 1; the launches of
              every driver step, cache build and eval batch, checked
              exactly; the first eval batch's scores on the card against the
              CPU; driver steps/s and DataTime share, eval pairs/s, cache
              faces/s and checkpoint save ms
 10. serve    EmbeddingService(max_batch=256) + EmbeddingHTTPServer on
              127.0.0.1:0 in the fused configuration, fp32 and bf16: 16
              client threads POST /embed (1-8 faces, float32 and uint8
              bodies) for 5 s (bf16 3 s), each response against a direct
              embed; /verify against pair_cosine; /enroll 64 labels and
              /identify k=5 of the same faces (rank 1 exact, a duplicated
              face by lower index); /stats against what was sent and
              dispatched; single-face latency at one client; a short
              ss_kernel load; the launches of each counted window checked
              exactly against the batches dispatched
 11. int8     FFRNet.prepare(fold_bn=True, quantize_int8="encoder" / "all")
              in bf16 and fp32, dynamic and calibrated (calibrate_int8 on 8
              faces): int8 vs the fp32 float model on held-out faces, static
              vs dynamic on the calibration faces, the card vs the CPU, the
              launches of one embed exactly; EmbeddingService + HTTP with the
              int8_static encoder; two --int8_encoder 1 driver runs (raw-image
              steps with the eval on the float encoder; a bf16 feature-cache
              build and its fingerprint); int8 embed faces/s at N=256 beside
              bf16 and fp32, N=1 latency, and int8_conv's time per encoder
              forward beside its bound, its twin and cuDNN's bf16 convolutions
              of the same shapes (a yardstick, not the same function)
 12. export   tools/export_model.export_embed with a symbolic batch, saved
              and loaded with torch.export, for fused fp32 and bf16,
              ss_kernel fp32 and the calibrated bf16 int8 "all" model: the
              loaded graph's ffrnet.* operator nodes (24 se_gating, 1
              channel_branch or self_similarity, 67 int8_conv), its
              outputs at N=1, 3 and 256 against embed (fp32 1e-4, else
              cosine >= 0.999), the launches of each call exactly, and its
              N=256 faces/s beside embed's
 13. data_parallel
              two ranks spawned on cuda:0 under a gloo group they make
              (NCCL puts no two ranks on one card) run make_distributed_step
              (fused) and make_distributed_feature_step (ss_kernel) for 2
              SGD updates on their halves of a global batch of 64 at full
              width, against one process on the whole batches (parameters
              1e-5, losses 1e-4 rel, rank checksums equal, launches per
              rank per step exact), then evaluate_pairs_multiprocess over
              a 600-pair tree (fold results bit-equal to evaluate_pairs);
              python -m ffrnet_torch.train's main under
              FFRNET_DISTRIBUTED=1 RANK=0 WORLD_SIZE=1 (NCCL) against the
              same run without it, and --mesh_data 2 refused; FFRNet.shard()
              bit-equal to embed at N=1, 11, 256, shard over cuda:0 twice
              (the pad, split and gather) within 1e-4, and an
              EmbeddingService over it; each rank's step ms beside the one
              process's
 14. model_axis
              the class-sharded CosFace head (10575 classes padded to 10576,
              5288 rows a rank) under gloo on cuda:0: make_distributed_step
              (fused) on a 1x2 mesh (2 ranks) and make_distributed_feature_step
              (ss_kernel) on a 2x2 mesh (4 ranks), 2 SGD updates on a global
              batch of 64 against one process (parameters 2e-5, losses 1e-4
              rel, TrainAcc equal, padded row and momentum exactly 0,
              checksums equal, launches per rank per step exact); the 2x2
              state saved by save_orbax, loaded under 1x2 and in one process
              bit-equal, one more update each against an uninterrupted run;
              the driver with --ckpt_backend orbax under NCCL at world size 1
              (kept steps, the resumed state bit-equal to the step it loads,
              step 8 within 2e-5 of an uninterrupted run) and --mesh_model 2
              refused; step, save_orbax and load_orbax ms
 15. extras   SELayer (x + the se_gating kernel) at IR-SE50's four SE shapes
              and the reference's SELayer(64, 16) on 7x7, N=64, fp32 and bf16,
              against x + se_gating_plain, one launch per call; HGBlock at
              depth 2 on (256, 512, 7, 7) (the nearest-exact resize) and
              depth 4 on (64, 64, 56, 56), MobileFaceNet(512) at N=256 (fp32
              and bf16, faces/s) and the Arcface and AmSoftmax heads at 51332
              classes, each card against CPU; examples/train_synthetic (20
              bf16 steps), tools/bench_eval at its defaults (6,000 pairs,
              bf16) and with --sync_per_batch, and tools/bench_driver at its
              defaults and with --upload_only 1, their launches checked
              exactly, pairs/s and imgs/s logged
 16. int8_tools
              the int8 tool family at full width, bf16: tools/synth (a key
              gives one batch; the noise-free batch and 600 eval pairs
              exact; the ms of an N=64 draw); tools/int8_cache (encoder and
              RecNet scales: miss then hit, scales and N=256 outputs
              bit-equal, each forward's launches exact, an entry less one
              path stale, the miss's and hit's times logged); bench_int8
              (--batches 128,256,512, four margins; held-out min cosine
              >= 0.99 for both int8 arms); bench_int8_recnet at N=256
              (isolated min cosines >= 0.99; one band warp per pipeline
              call); bench_int8_budget (3 seeds x 100 steps; rows finite,
              accuracies in [0, 1], each split's scoring launches checked);
              bench_int8_convergence (300 steps, checkpoints every 100; 52
              int8_conv per int8 step, none in the float-encoder scoring;
              finite deltas); every tool run's launches exact; the scale
              cache and --out in a temporary directory, and the JAX tools'
              tracked .int8_scales.json and docs/int8_*.json unchanged

The last three lines are the kernels' JSON record, the card's name and
power limit as nvidia-smi gives them, and the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32 SIMT FLOP/s
# and TF32 tensor-core FLOP/s; every kernel computes in fp32 whatever its
# storage type, channel_branch's two large products as TF32 hi/lo splits
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
INT8_OPS_PER_S = 1979e12

KERNELS = {
    "se_gating": ("ffrnet_torch/csrc/se_gating.cu", "ffrnet_tpu/ops/pallas/se_gating.py:55"),
    "self_similarity": ("ffrnet_torch/csrc/self_similarity.cu",
                        "ffrnet_tpu/ops/pallas/self_similarity.py:67"),
    "channel_branch": ("ffrnet_torch/csrc/channel_branch.cu",
                       "ffrnet_tpu/ops/pallas/channel_branch.py:136"),
    "warp_affine_full": ("ffrnet_torch/csrc/warp.cu", "ffrnet_tpu/ops/pallas/warp.py:88"),
    "warp_affine_band": ("ffrnet_torch/csrc/warp.cu", "ffrnet_tpu/ops/pallas/warp.py:182"),
    # XLA's int8 conv (and :169, its int8 dot); no Pallas original
    "int8_conv": ("ffrnet_torch/csrc/int8_conv.cu", "ffrnet_tpu/ops/quant.py:143"),
}
WARPS = ("warp_affine_full", "warp_affine_band")
# (Cin, Cout, input H = W, window, stride, padding) of every int8 site shape
# of IR-SE50 at 112x112 and of RecNet (7x7 maps reflect-padded to 9x9
# outside the conv); Cin 0 is the encoder's output Linear, K = 25088
INT8_SITES = [(64, 64, 112, 3, 1, 1), (64, 64, 112, 3, 2, 1), (64, 64, 56, 3, 1, 1),
              (64, 128, 56, 3, 1, 1), (128, 128, 56, 3, 2, 1), (64, 128, 56, 1, 2, 0),
              (128, 128, 28, 3, 1, 1), (128, 256, 28, 3, 1, 1), (256, 256, 28, 3, 2, 1),
              (128, 256, 28, 1, 2, 0), (256, 256, 14, 3, 1, 1), (256, 512, 14, 3, 1, 1),
              (512, 512, 14, 3, 2, 1), (256, 512, 14, 1, 2, 0), (512, 512, 7, 3, 1, 1),
              (0, 512, 1, 1, 1, 0),
              (561, 256, 9, 3, 1, 0), (256, 256, 9, 3, 1, 0), (256, 128, 9, 3, 1, 0),
              (128, 128, 9, 3, 1, 0), (128, 49, 9, 3, 1, 0), (49, 49, 9, 3, 1, 0),
              (1024, 512, 9, 3, 1, 0), (512, 512, 9, 3, 1, 0), (1536, 512, 9, 3, 1, 0)]
# int8 sites per forward: IR-SE50's 48 body convs, 3 projection shortcuts
# and the output Linear; RecNet's conv chains
INT8_ENCODER_SITES, INT8_RECNET_SITES = 52, 15
# (H, C, units) of the IR-SE50 stages: 24 SE gates per encoder forward
SE_STAGES = ((56, 64, 3), (28, 128, 4), (14, 256, 14), (7, 512, 3))
# tolerances: fp32 sums in another order (512-term for channel_branch);
# bf16: one rounding of the output at 8 mantissa bits
TOL = {("fp32", "se_gating"): (1e-5, 1e-5), ("fp32", "self_similarity"): (1e-5, 1e-5),
       ("fp32", "channel_branch"): (1e-4, 1e-4)}
BF16_TOL = (2e-2, 2e-2)
# card vs CPU, fp32 with TF32 off: convolutions summed in other orders
# through 49 conv layers
PATH_TOL = (1e-4, 1e-4)
# warps, 0-255 pixels: kernel and twin round the same fp32 operations, so
# they agree to the bit (0 expected); fp32 outputs 1e-4, bf16 outputs one
# bf16 step at 128-255
WARP_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1.0, 0.0)}
# F.grid_sample vs the plain warp: its coordinates pass through [-1, 1]
# and back, about 1e-5 px off on a 250 px source
LIBRARY_WARP_TOL = (5e-2, 0.0)
# the pinned crop of tests/fixtures/golden (JAX's gather warp on fp32
# matrices) vs the port's guarded warp: the JAX package's bound for its
# non-gather paths (tests/test_golden_e2e.py)
GOLDEN_CROP_TOL = (2e-2, 0.0)
GOLDEN = os.path.join(HERE, "tests", "fixtures", "golden", "expected.npz")


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def check_close(what, got, want, atol, rtol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{what}: max_abs_err {err.max().item():.3e} above "
                             f"atol {atol} + rtol {rtol}")
    return err.max().item()


def host_ms(fn, samples, warmup=2):
    """Per-call host-clock milliseconds of `fn` ending in a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return np.asarray(out)


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20, warmup=3, replays=3):
    """Device milliseconds per call of `fn`, from `replays` timed replays of
    a CUDA graph of `iters` calls (after `warmup` calls and one replay): the
    launches' host time, which exceeds a small kernel's own, is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


# ---------------------------------------------------------------- phase 1, 2


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU")
    import ffrnet_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(ffrnet_torch.__file__))) != HERE:
        raise SystemExit(f"chip_smoke: ffrnet_torch imported from {ffrnet_torch.__file__}, "
                         f"not from the checkout at {HERE}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log("device", f"{name} | nvidia-smi: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    return name, smi


def phase_build():
    from ffrnet_torch.ops.kernels import _build

    secs = _build.build_all()
    libs = ", ".join(_build.library_path(n).name for n in _build.KERNELS)
    log("build", f"{secs:.1f} s for {len(_build.KERNELS)} kernels (nvcc "
        f"{' '.join(_build.NVCC_FLAGS[:2])}): {libs}")


# ------------------------------------------------------------------ phase 3


def c4c_weights(model, seed, biases, device):
    """The `_collapse` operands of a RecNet's Conv4Channel, with random
    biases or with none."""
    from ffrnet_torch.ops.kernels.channel_branch import _collapse

    g = gen(seed)
    tree = {}
    for k, v in model.recnet.c4c_params().items():
        if k.startswith("lin"):
            b = 0.1 * torch.randn(v["w"].shape[0], generator=g) if biases else None
            tree[k] = {"w": v["w"].detach().float().cpu(), "b": b}
        else:
            tree[k] = {"slope": v["slope"].detach().float().cpu()}
    return tuple(t.to(device) for t in _collapse(tree))


def phase_kernels(model, dev):
    from ffrnet_torch.ops.kernels.se_gating import _se_plan, se_gating, se_gating_plain

    n = 64
    g = gen(10)
    errs = {k: 0.0 for k in KERNELS}
    for dname, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        clusters = set()
        for h, c, _ in SE_STAGES:
            w1 = (0.2 * torch.randn(c // 16, c, generator=g)).to(dev, dt)
            w2 = (0.2 * torch.randn(c, c // 16, generator=g)).to(dev, dt)
            plan = _se_plan(c, h * h, c // 16, dt.itemsize)
            clusters.add(plan[0])
            tol = TOL.get((dname, "se_gating"), BF16_TOL)
            for n_se in (1, 3, n):
                x = torch.randn(n_se, c, h, h, generator=g).to(dev, dt)
                if n_se > 1:
                    x[1] = 0  # an all-zero map: its gate is sigmoid(0), finite
                e = check_close(f"se_gating {dname} {tuple(x.shape)}", se_gating(x, w1, w2),
                                se_gating_plain(x, w1, w2), *tol)
                zero = " (sample 1 zero)" if n_se > 1 else ""
                log("kernels", f"se_gating {dname} x{tuple(x.shape)}{zero} plan (cluster, "
                    f"channels/CTA, smem) {plan} max_abs_err {e:.3e} tol atol={tol[0]} "
                    f"rtol={tol[1]} (|x| <= {x.abs().max().item():.1f})")
                if dname == "fp32":
                    errs["se_gating"] = max(errs["se_gating"], e)
        if clusters != {1, 2, 4, 8}:
            raise AssertionError(f"se_gating {dname}: cluster sizes {sorted(clusters)} checked")
        e = check_self_similarity(dev, dname, dt, g)
        if dname == "fp32":
            errs["self_similarity"] = e
        e = check_channel_branch(model, dev, dname, dt, g, n)
        if dname == "fp32":
            errs["channel_branch"] = e
    errs["int8_conv"] = check_int8_conv(dev, g)
    torch.cuda.synchronize()
    return errs


def int8_case(site, n, g, dev, fill=None):
    """Random int8 operands of one site shape as the kernel takes them
    (to_nhwc, pack_weight), a deq and a bias; `fill` sets every activation
    to it and every weight to 127 (+-127: the largest accumulators)."""
    from ffrnet_torch.ops.kernels.int8_conv import pack_weight, to_nhwc

    cin, cout, h, k, _, _ = site
    x = torch.randint(-127, 128, (n, 25088) if cin == 0 else (n, cin, h, h), generator=g,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (cout, 25088) if cin == 0 else (cout, cin, k, k), generator=g,
                      dtype=torch.int8)
    if fill is not None:
        x.fill_(fill)
        w.fill_(127)
    deq = torch.rand(cout, generator=g) * 1e-4
    bias = torch.randn(cout, generator=g)
    return to_nhwc(x.to(dev)), pack_weight(w.to(dev)), deq.to(dev), bias.to(dev)


def int8_plan_of(args, stride, pad, dt):
    """The plan _launch gives an int8_conv call (xq, wp, ...) on this card."""
    from ffrnet_torch.ops.kernels.int8_conv import _int8_plan, _sms

    xq, wp = args[0], args[1]
    n, h, w, cp = xq.shape
    coutp, kh, kw, _ = wp.shape
    return _int8_plan(n, h, w, cp, coutp, kh, kw, stride, pad, dt, _sms(xq.device))


def plan_str(plan):
    return (f"BN {plan.bn} BK {plan.bk} {plan.stages} stages, "
            + (f"split-K x{plan.cluster}" if plan.cluster > 1 else "persistent")
            + f", {plan.tiles} tiles on {plan.grid} CTAs")


def check_int8_conv(dev, g):
    """int8_conv vs its twin (the integer product in float64, exact, then
    the same two fp32 roundings) at every int8 site shape, N = 1, 2, 3 and
    64, fp32 and bf16 outputs, with bias (and without at N = 3): equal to
    the bit; N = 1 and 2 put every shape's K split over a cluster; N = 256 at
    the Linear and the 14x14 256->256 site (whose 392 tiles are no multiple
    of the persistent grid); then a zero map and operands at +-127
    (accumulators of 127^2 K) at the first encoder shape, the Linear, C = 561
    and C = Cout = 49, and an input view 8 bytes off a 16-byte boundary.
    Logs the plan each shape took. Returns the largest error."""
    from ffrnet_torch.ops.kernels.int8_conv import int8_conv, int8_conv_plain

    def same(what, args, stride, pad, dt):
        got = int8_conv(*args, stride=stride, padding=pad, out_dtype=dt)
        want = int8_conv_plain(*args, stride=stride, padding=pad, out_dtype=dt)
        if got.dtype != dt or got.shape != want.shape or not torch.equal(got, want):
            err = (got.float() - want.float()).abs().max().item()
            plan = int8_plan_of(args, stride, pad, dt)
            raise AssertionError(f"int8_conv {what}: not bit-equal to the twin "
                                 f"(max_abs_err {err:.3e}; plan {plan})")
        return (got.float() - want.float()).abs().max().item()

    t0, calls, worst = time.perf_counter(), 0, 0.0
    split, ragged, whole = set(), [], {}
    cases = [(site, n) for site in INT8_SITES for n in (1, 2, 3, 64)]
    cases += [(INT8_SITES[15], 256), (INT8_SITES[10], 256)]
    for site, n in cases:
        xq, wp, deq, bias = int8_case(site, n, g, dev)
        plans = []
        for dt in (torch.float32, torch.bfloat16):
            plan = int8_plan_of((xq, wp), site[4], site[5], dt)
            plans.append(plan)
            if n == 1:
                whole[site] = plan
            if plan.cluster > 1:
                split.add(site)
            elif plan.tiles > plan.grid and plan.tiles % plan.grid:
                ragged.append((site, n))
            for b in ((bias, None) if n == 3 else (bias,)):
                worst = max(worst, same(f"{site} N={n} {dt} bias={b is not None}",
                                        (xq, wp, deq, b), site[4], site[5], dt))
                calls += 1
        if n in (1, 256) or plans[0] != plans[1]:
            log("kernels", f"int8_conv plan {site} N={n}: {plan_str(plans[0])}")
    # K splits wherever it can at N = 1: in 2 or more stages, over tiles
    # that leave room for a cluster of 2 per tile
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    unsplit = {s for s, p in whole.items() if p.kstages < 2 or 2 * p.tiles > sms}
    if split != set(INT8_SITES) - unsplit or (INT8_SITES[10], 256) not in ragged:
        raise AssertionError(f"int8_conv: split-K at {len(split)} of {len(INT8_SITES)} shapes "
                             f"(not at {sorted(set(INT8_SITES) - split)}), ragged persistent "
                             f"grids at {ragged}")
    edges = [INT8_SITES[0]] + [s for s in INT8_SITES if s[0] in (0, 561, 49)]
    for site in edges:
        for fill in (0, 127, -127):
            args = int8_case(site, 3, g, dev, fill=fill)
            for dt in (torch.float32, torch.bfloat16):
                worst = max(worst, same(f"{site} filled {fill}", args, site[4], site[5], dt))
                calls += 1
    site = INT8_SITES[-1]
    xq, wp, deq, bias = int8_case(site, 3, g, dev)
    buf = torch.zeros(xq.numel() + 8, dtype=torch.int8, device=dev)
    view = buf[8:].view(xq.shape)
    view.copy_(xq)
    worst = max(worst, same("misaligned input", (view, wp, deq, bias), site[4], site[5],
                            torch.float32))
    torch.cuda.synchronize()
    log("kernels", f"int8_conv: {len(INT8_SITES)} site shapes (16 of IR-SE50 with the Linear, 9 of "
        f"RecNet with C 561/49 and Cout 49) x N 1/2/3/64 x fp32/bf16 out, with and without bias, "
        f"N=256 at the Linear and at 14x14 256->256, split-K at {len(split)} shapes (not at "
        f"{sorted(unsplit)}: one K stage, or more tiles at N=1 than clusters of 2 fit), "
        f"{len(ragged)} persistent grids not dividing their tiles, a zero map, operands at +-127 "
        f"(|acc| up to 127^2 K), a misaligned input: {calls + 1} calls bit-equal to the twin "
        f"(max_abs_err {worst:.1e}) in {time.perf_counter() - t0:.1f} s")
    return worst


def check_self_similarity(dev, dname, dt, g):
    """self_similarity vs its twin at the main path's (256, 512, 7, 7), the
    same x100, and every (N, C, HW) of N 1, 3, 64 by C 64, 192, 512 by HW
    16, 49, 64. Sample 0 has a zero channel row (its norm takes the 1e-12
    clamp) and sample 1, where there is one, is all zero. Both outputs must
    be exactly symmetric: each off-diagonal tile of ss_channel is stored
    twice from one value. Returns the largest error."""
    from ffrnet_torch.ops.kernels.self_similarity import (self_similarity_fused,
                                                          self_similarity_fused_plain)

    tol = TOL.get((dname, "self_similarity"), BF16_TOL)
    edges = [(n, c, h) for c in (64, 192, 512) for h in (4, 7, 8) for n in (1, 3, 64)]
    cases = [((256, 512, 7, 7), 1), ((256, 512, 7, 7), 100)]
    cases += [((n, c, h, h), 1) for n, c, h in edges]
    worst = {}
    for shape, scale in cases:
        x = scale * torch.randn(*shape, generator=g)
        x[0, 5] = 0
        if shape[0] > 1:
            x[1] = 0
        x = x.to(dev, dt)
        name = f"x{shape}{' x100' if scale > 1 else ''}"
        key = name if shape[0] == 256 else "edges"
        for which, got, want in zip(("ss_space", "ss_channel"), self_similarity_fused(x),
                                    self_similarity_fused_plain(x)):
            what = f"self_similarity {which} {dname} {name}"
            if got.dtype != x.dtype or got.shape != want.shape:
                raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)}")
            e = check_close(what, got, want, *tol)
            if not torch.equal(got, got.transpose(1, 2)):
                raise AssertionError(f"{what}: not exactly symmetric")
            worst[key, which] = max(worst.get((key, which), 0.0), e)
    for key in [k for k, w in worst if w == "ss_space"]:
        what = key if key != "edges" else (f"{len(edges)} edge shapes (N 1/3/64, C 64/192/512, "
                                           f"HW 16/49/64)")
        log("kernels", f"self_similarity {dname} {what}, a zero channel row and a zero sample: "
            f"max_abs_err ss_space {worst[key, 'ss_space']:.3e} ss_channel "
            f"{worst[key, 'ss_channel']:.3e} tol atol={tol[0]} rtol={tol[1]}; both exactly "
            f"symmetric")
    return max(worst.values())


def check_channel_branch(model, dev, dname, dt, g, n):
    """channel_branch vs its twin at (N, 512, 49), with and without biases:
    N = 1, 3 (sample 1 zero: out is 0 there) and n; saturated sigmoids (W5
    and b5 x8, which puts many logits far past the sigmoid's knee); a batch
    x8, whose fp32 atol grows with it (the fp32 twin alone is about 1e-4
    off an fp64 evaluation there, tests/test_torch_cb_split.py). Returns
    the largest fp32 error of the unscaled cases."""
    from ffrnet_torch.ops.kernels.channel_branch import channel_branch, channel_branch_plain

    worst = 0.0
    for biases in (True, False):
        w = c4c_weights(model, 11, biases, dev)
        cases = []
        for n_cb in (1, 3, n):
            x = torch.randn(n_cb, 512, 49, generator=g)
            if n_cb == 3:
                x[1] = 0
            cases.append((f"x{tuple(x.shape)}{' (sample 1 zero)' if n_cb == 3 else ''}",
                          x.to(dev, dt), w, 1))
        x = torch.randn(n, 512, 49, generator=g).to(dev, dt)
        saturated = w[:10] + (8 * w[10], 8 * w[11])
        cases.append((f"x{tuple(x.shape)} W5, b5 x8 (saturated)", x, saturated, 1))
        cases.append((f"x{tuple(x.shape)} x8", 8 * x, w, 8))
        for what, x, wt, scale in cases:
            tol = TOL.get((dname, "channel_branch"), BF16_TOL)
            if dname == "fp32":
                tol = (tol[0] * scale, tol[1])
            want = channel_branch_plain(x, wt)
            got = channel_branch(x, wt)
            e = check_close(f"channel_branch {dname} {what} biases={biases}", got, want, *tol)
            zero = (x == 0).flatten(1).all(1)
            if not (got[zero] == 0).all():
                raise AssertionError(f"channel_branch {dname} {what}: a zero sample is not 0")
            log("kernels", f"channel_branch {dname} {what} biases={biases} max_abs_err {e:.3e} "
                f"tol atol={tol[0]:g} rtol={tol[1]} (|out| <= {want.abs().max().item():.1f})")
            if scale == 1:
                worst = max(worst, e)
    return worst


def face_landmarks(n, seed):
    """tests/test_pallas_kernels.py's recipe: the ArcFace reference points
    at the LFW face scale with 2 px of noise, (n, 5, 2) float32."""
    from ffrnet_torch.ops.align import ARCFACE_REF_PTS

    rng = np.random.default_rng(seed)
    return (ARCFACE_REF_PTS[None] * 2.1 + rng.normal(0, 2, (n, 5, 2)) + 15).astype(np.float32)


def rotated(lmk, theta, scale=1.0, center=None):
    """Landmarks rotated by `theta` about their mean, scaled, and moved so
    that their mean lands on `center`."""
    rot = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    mean = lmk.mean(-2, keepdims=True)
    return (((lmk - mean) @ rot.T) * scale
            + (mean if center is None else np.asarray(center))).astype(np.float32)


def warp_mats(lmk, ref_pts):
    from ffrnet_torch.ops.align import cv2_transform

    ref = torch.from_numpy(np.broadcast_to(ref_pts, lmk.shape).copy())
    return cv2_transform(torch.from_numpy(lmk), ref)


def phase_warp_kernels(dev):
    """Both warps vs their twins on uniform noise, N=64, 250x250x3."""
    from ffrnet_torch.api import REF_PTS_112
    from ffrnet_torch.ops.align import ARCFACE_REF_PTS, auto_band_crop_w, warp_affine
    from ffrnet_torch.ops.kernels.warp import (warp_affine_band, warp_affine_band_plain,
                                               warp_affine_full, warp_affine_full_plain)

    n = 64
    imgs = torch.from_numpy(np.random.default_rng(60).uniform(0, 255, (n, 250, 250, 3))
                            .astype(np.float32)).to(dev)
    lmk = face_landmarks(n, 61)
    errs = {k: 0.0 for k in WARPS}

    def check(name, what, got, want):
        tol = WARP_TOL[got.dtype]
        e = check_close(f"{name} {what}", got, want, *tol)
        log("kernels", f"{name} {what} max_abs_err {e:.3e} tol atol={tol[0]}")
        if got.dtype == torch.float32:
            errs[name] = max(errs[name], e)

    for out_hw, ref in (((112, 112), REF_PTS_112), ((112, 96), ARCFACE_REF_PTS)):
        mats = warp_mats(lmk, ref).to(dev)
        for cd in (torch.float32, torch.bfloat16):
            check("warp_affine_full", f"{out_hw} compute {cd}",
                  warp_affine_full(imgs, mats, out_hw=out_hw, compute_dtype=cd),
                  warp_affine_full_plain(imgs, mats, out_hw=out_hw, compute_dtype=cd))
        guard = auto_band_crop_w(lmk, ref, (250, 250), out_hw[0])
        for cw in sorted({64, 96, guard}):
            check("warp_affine_band", f"{out_hw} crop_w {cw}{' (guard)' if cw == guard else ''}",
                  warp_affine_band(imgs, mats, out_hw=out_hw, crop_w=cw),
                  warp_affine_band_plain(imgs, mats, out_hw=out_hw, crop_w=cw))
    # the band contract violated: faces rotated 0.5 rad need a ~170-column
    # window; at crop_w 64 kernel and twin still compute the same thing
    lmk_rot = rotated(lmk, 0.5)
    mats = warp_mats(lmk_rot, REF_PTS_112).to(dev)
    need = auto_band_crop_w(lmk_rot, REF_PTS_112, (250, 250), 112)
    got = warp_affine_band(imgs, mats, out_hw=(112, 112), crop_w=64)
    check("warp_affine_band", f"violated bound (guard wants {need}) crop_w 64", got,
          warp_affine_band_plain(imgs, mats, out_hw=(112, 112), crop_w=64))
    off = (got - warp_affine(imgs, mats, out_hw=(112, 112))).abs().max().item()
    if need is not None and need <= 64 or off < 1.0:
        raise AssertionError(f"the violated-bound case is not violated (guard {need}, "
                             f"{off:.3f} off the gather)")
    log("kernels", f"warp_affine_band violated bound: {off:.1f} off the gather, as the "
        f"Pallas kernel would be")
    # bfloat16 images, once for each kernel
    mats = warp_mats(lmk, REF_PTS_112).to(dev)
    imgs_bf = imgs.bfloat16()
    check("warp_affine_full", "bf16 images", warp_affine_full(imgs_bf, mats, out_hw=(112, 112)),
          warp_affine_full_plain(imgs_bf, mats, out_hw=(112, 112)))
    check("warp_affine_band", "bf16 images",
          warp_affine_band(imgs_bf, mats, out_hw=(112, 112), crop_w=96),
          warp_affine_band_plain(imgs_bf, mats, out_hw=(112, 112), crop_w=96))
    torch.cuda.synchronize()
    return errs


# ------------------------------------------------------------------ phase 4


def synthetic_pairs(n_pairs, dev, seed=20, batch=100):
    """Pair batches of uint8 faces on the device: a 'same' pair is a face
    and a noisy copy of it, a 'different' pair two faces."""
    g = gen(seed)
    faces = torch.randint(0, 256, (n_pairs, 112, 112, 3), generator=g, dtype=torch.uint8)
    labels = torch.arange(n_pairs) % 2
    other = faces.roll(1, dims=0)
    noise = torch.randint(-12, 13, faces.shape, generator=g)
    noisy = (faces.int() + noise).clamp(0, 255).to(torch.uint8)
    img2 = torch.where(labels[:, None, None, None] == 1, noisy, other)
    faces, img2, labels = faces.to(dev), img2.to(dev), labels.to(dev)
    return [{"img1": faces[i:i + batch], "img2": img2[i:i + batch],
             "label": labels[i:i + batch]} for i in range(0, n_pairs, batch)]


def drive(model, name, faces_u8, pairs):
    """embed (uint8 and float), verify (mixed sides) and evaluate; returns
    the number of encoder forwards and the embeddings of the uint8 batch."""
    from ffrnet_torch.eval.lfw import pair_cosine

    raw_u, rect_u = model.embed(faces_u8)
    faces_f = (faces_u8.cpu().numpy().astype(np.float32) / 255.0 - 0.5) / 0.5
    raw_f, rect_f = model.embed(faces_f)
    e1 = check_close(f"{name}: uint8 vs float raw", raw_u, raw_f, 1e-6, 0)
    e2 = check_close(f"{name}: uint8 vs float rect", rect_u, rect_f, 1e-6, 0)
    for t, shape in ((raw_u, (64, 512)), (rect_u, (64, 512))):
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            raise AssertionError(f"{name}: embedding {tuple(t.shape)} not finite {shape}")
    norms = raw_u.norm(dim=1)
    check_close(f"{name}: raw embedding norms", norms, torch.ones_like(norms), 1e-5, 0)
    s = model.verify(faces_u8[:32], faces_f[32:])  # mixed uint8 / float sides
    e3 = check_close(f"{name}: verify vs embed", s, pair_cosine(rect_u[:32], rect_u[32:]),
                     1e-5, 1e-5)
    acc_rect, acc_raw = model.evaluate(pairs)
    if not (0 <= acc_rect <= 1 and 0 <= acc_raw <= 1):
        raise AssertionError(f"{name}: accuracies {acc_rect}, {acc_raw}")
    log("main", f"{name}: embed 64 uint8 == float (raw {e1:.1e}, rect {e2:.1e}); verify 32 "
        f"mixed pairs (err {e3:.1e}); evaluate {sum(len(b['label']) for b in pairs)} pairs, "
        f"10 folds: acc_rect {acc_rect:.4f} acc_raw {acc_raw:.4f}")
    return 3 + len(pairs), (raw_u, rect_u)


def cpu_parity(model, name, faces_u8, card_out):
    from ffrnet_torch.api import FFRNet

    cpu = FFRNet(model.encoder, model.recnet, model.cfg, "cpu").prepare()
    raw_c, rect_c = cpu.embed(faces_u8[:4].cpu())
    e_raw = check_close(f"{name}: card vs CPU raw", card_out[0][:4].cpu(), raw_c, *PATH_TOL)
    e_rect = check_close(f"{name}: card vs CPU rect", card_out[1][:4].cpu(), rect_c, *PATH_TOL)
    log("main", f"{name}: card vs CPU (plain versions), 4 faces fp32: raw max_abs_err "
        f"{e_raw:.3e}, rect {e_rect:.3e} (tol atol={PATH_TOL[0]} rtol={PATH_TOL[1]})")


def phase_main(models, dev):
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts

    faces = torch.randint(0, 256, (64, 112, 112, 3), generator=gen(30),
                          dtype=torch.uint8).to(dev)
    pairs = synthetic_pairs(600, dev)
    counts = {}
    for name, model in models.items():
        reset_launch_counts()
        forwards, out = drive(model, name, faces, pairs)
        torch.cuda.synchronize()
        counts[name] = (forwards, launch_counts())
        cpu_parity(model, name, faces, out)
    return counts


# ------------------------------------------------------------------ phase 5


def ingest_batches():
    """The golden fixture's decoded face as host uint8 canvases: 64 copies
    with its landmarks (perturbed by 2 px beyond the first), and 4 with
    landmarks scaled x12 and rotated 0.5 rad about the image's centre, which
    no band window covers (x12 alone still fits a 224-wide band)."""
    from ffrnet_torch.ops.align import ARCFACE_REF_PTS

    exp = np.load(GOLDEN)
    lmk = exp["landmarks"].astype(np.float32)
    faces = np.repeat(exp["decoded"][None], 64, axis=0)
    lmk64 = np.repeat(lmk[None], 64, axis=0)
    lmk64[1:] += np.random.default_rng(70).normal(0, 2, (63, 5, 2)).astype(np.float32)
    extreme = rotated(np.repeat(ARCFACE_REF_PTS[None] * 12.0, 4, axis=0), 0.5,
                      center=(125.0, 125.0))
    return exp, (faces, lmk64), (faces[:4].copy(), extreme)


def phase_ingest(model, dev):
    """embed_canvas in the fused configuration: returns the launch counts
    of the two card runs."""
    from ffrnet_torch.api import FFRNet, REF_PTS_112
    from ffrnet_torch.ops.align import ARCFACE_REF_PTS, auto_band_crop_w
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts

    exp, (faces, lmk), (faces_x, lmk_x) = ingest_batches()
    cw = auto_band_crop_w(lmk, ARCFACE_REF_PTS, faces.shape[1:3], 112)
    if cw is None or auto_band_crop_w(lmk_x, REF_PTS_112, faces.shape[1:3], 112) is not None:
        raise AssertionError("the ingest batches do not take the band and the full kernel")
    # the default frame of the pinned crop for the 64 faces; the 112x112
    # frame of embed_files for the extreme ones
    runs = ((faces, lmk, ARCFACE_REF_PTS), (faces_x, lmk_x, REF_PTS_112))
    reset_launch_counts()
    card = [model.embed_canvas(f, lm, ref_pts=ref) for f, lm, ref in runs]
    torch.cuda.synchronize()
    counts = launch_counts()
    raw, rect, crops = card[0]
    for t, shape in ((raw, (64, 512)), (rect, (64, 512)), (crops, (64, 112, 112, 3)),
                     (card[1][0], (4, 512))):
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            raise AssertionError(f"ingest: {tuple(t.shape)} not finite {shape}")
    e_gold = check_close("ingest: crop 0 vs the pinned crop", crops[0].cpu(),
                         torch.from_numpy(exp["aligned"]), *GOLDEN_CROP_TOL)
    log("ingest", f"64 fixture faces, band kernel at crop_w {cw}: crop 0 vs the pinned "
        f"crop max_abs_err {e_gold:.3e} (tol atol={GOLDEN_CROP_TOL[0]}); 4 extreme faces "
        f"through the full kernel")
    cpu = FFRNet(model.encoder, model.recnet, model.cfg, "cpu").prepare()
    for (f, lm, ref), (c_raw, c_rect, c_crops), name in zip(runs, card, ("band", "full")):
        e_crop = check_close(f"ingest {name}: card vs CPU crops", c_crops.cpu(),
                             cpu.align(f, lm, out_hw=(112, 112), ref_pts=ref), *PATH_TOL)
        raw_c, rect_c, _ = cpu.embed_canvas(f[:4], lm[:4], ref_pts=ref)
        e_raw = check_close(f"ingest {name}: card vs CPU raw", c_raw[:4].cpu(), raw_c,
                            *PATH_TOL)
        e_rect = check_close(f"ingest {name}: card vs CPU rect", c_rect[:4].cpu(), rect_c,
                             *PATH_TOL)
        log("ingest", f"{name} batch card vs CPU (plain versions): {len(f)} crops max_abs_err "
            f"{e_crop:.3e}; 4 faces raw {e_raw:.3e}, rect {e_rect:.3e} (tol atol="
            f"{PATH_TOL[0]} rtol={PATH_TOL[1]})")
    return counts


# ------------------------------------------------------------------ phase 6


def phase_counts(counts, ingest):
    """`counts`: per main-path model, (forwards, launch counts); `ingest`:
    the launch counts of the ingest path's two embed_canvas calls."""
    total = {k: 0 for k in KERNELS}
    for name, (forwards, c) in counts.items():
        expected = {"se_gating": 24 * forwards,
                    "channel_branch": forwards if name.startswith("fused") else 0,
                    "self_similarity": forwards if name.startswith("ss_kernel") else 0,
                    "warp_affine_full": 0, "warp_affine_band": 0, "int8_conv": 0}
        if c != expected:
            raise AssertionError(f"{name}: launch counts {c}, expected {expected} for "
                                 f"{forwards} forwards")
        log("counts", f"{name}: {forwards} encoder+RecNet forwards -> {c} "
            f"(24 se_gating per forward, its RecNet kernel once per forward)")
        for k in total:
            total[k] += c[k]
    expected = {"se_gating": 48, "channel_branch": 2, "self_similarity": 0,
                "warp_affine_full": 1, "warp_affine_band": 1, "int8_conv": 0}
    if ingest != expected:
        raise AssertionError(f"ingest: launch counts {ingest}, expected {expected}")
    log("counts", f"ingest (fused): 2 guarded align calls + 2 forwards -> {ingest} (the band "
        f"kernel for the 64 faces, the full kernel for the extreme batch)")
    for k in total:
        total[k] += ingest[k]
    missing = [k for k, v in total.items() if v == 0 and k != "int8_conv"]  # phase 11's
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return total


# ------------------------------------------------------------------ phase 7


def roof(nbytes, ops):
    """(bound_ms, bound_by): the larger of `nbytes` at the HBM rate and
    `ops` at the fp32 SIMT rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def se_bound(n, itemsize, stages=SE_STAGES):
    """(bound_ms, bound_by) of the SE gates of `stages` (H, C, gates) at
    batch n: each map read once and written once, the weights read once;
    the pool, the two mat-vecs and the scale in fp32."""
    nbytes = ops = 0
    for h, c, units in stages:
        r, hw = c // 16, h * h
        nbytes += units * (2 * n * c * hw + 2 * c * r) * itemsize
        ops += units * (2 * n * c * hw + 4 * n * c * r)
    return roof(nbytes, ops)


def cb_bound(n, itemsize=4, c=512, hw=49):
    """(bound_ms, bound_by) of channel_branch at batch n: the largest of
    its two products h W5^T and M X on the tensor cores as 3xTF32 (M X as
    2xTF32 in bf16, whose X is exact in TF32), the rest (t, h, the two
    affines) on fp32 SIMT, and the bytes (x read once, out written once,
    fp32 weights read once)."""
    logits, values = 2 * n * c * c * 32, 2 * n * c * c * hw
    passes = 3 if itemsize == 4 else 2
    t_tc = (3 * logits + passes * values) / TF32_FLOP_PER_S * 1e3
    rest = n * (2 * 32 * c * hw + 4 * c * 32 * hw + 4 * c * 32 * 32)
    t_ops = rest / FP32_FLOP_PER_S * 1e3
    nbytes = (2 * n * c * hw * itemsize
              + (32 * (hw + c) + 2 * 32 * 32 + c * 32 + 3 * c + 4 * 32 + c) * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by = f"tensor cores ({'3xTF32' if itemsize == 4 else '3xTF32, M X 2xTF32'})"
    return max((t_tc, by), (t_ops, "operations"), (t_bytes, "bytes"))


def ss_bound(n, itemsize=4, c=512, hw=49):
    """(bound_ms, bound_by) of self_similarity at batch n: x read once, both
    Grams written once; both are symmetric, so a SYRK needs only their
    upper triangles, plus the rows' sums of squares, in fp32."""
    nbytes = n * c * hw * itemsize + n * (hw * hw + c * c) * itemsize
    ops = 2 * n * (hw * (hw + 1) // 2 * c + c * (c + 1) // 2 * hw) + 2 * n * c * hw
    return roof(nbytes, ops)


def bounds(n):
    """(bound_ms, bound_by) per kernel at batch n in fp32, from the bytes
    each must move (inputs read once, outputs written once) and the fp32
    operations it does (channel_branch: `cb_bound`)."""
    b = 4
    # the warps, (n, 250, 250, 3) -> (n, 112, 112, 3) with (n, 2, 3)
    # matrices: per output pixel 8 operations for its coordinates, 12 for
    # its four tent weights, 9 per channel for the 2x2 taps
    h, w, ch, p_out = 250, 250, 3, 112 * 112
    warp_bytes = (n * h * w * ch + n * 6 + n * p_out * ch) * b
    warp_ops = n * p_out * (20 + 9 * ch)
    return {"se_gating": se_bound(n, b), "self_similarity": ss_bound(n, b),
            "channel_branch": cb_bound(n),
            "warp_affine_full": roof(warp_bytes, warp_ops),
            "warp_affine_band": roof(warp_bytes, warp_ops)}


def grid_sample_theta(mats, src_hw, out_hw):
    """F.affine_grid's theta (normalized output -> normalized source, with
    align_corners=True) for cv2-convention forward matrices."""
    from ffrnet_torch.ops.align import _invert_2x3

    inv = _invert_2x3(mats.float()).double()
    half_w, half_h = (out_hw[1] - 1) / 2, (out_hw[0] - 1) / 2
    theta = torch.empty_like(inv)
    for r, size in ((0, src_hw[1]), (1, src_hw[0])):
        k = 2.0 / (size - 1)
        theta[:, r, 0] = k * inv[:, r, 0] * half_w
        theta[:, r, 1] = k * inv[:, r, 1] * half_h
        theta[:, r, 2] = k * (inv[:, r, 0] * half_w + inv[:, r, 1] * half_h + inv[:, r, 2]) - 1
    return theta.float()


def phase_times(models, dev, card):
    from ffrnet_torch.api import REF_PTS_112
    from ffrnet_torch.ops.align import auto_band_crop_w
    from ffrnet_torch.ops.kernels.channel_branch import channel_branch, channel_branch_plain
    from ffrnet_torch.ops.kernels.se_gating import se_gating, se_gating_plain
    from ffrnet_torch.ops.kernels.self_similarity import (self_similarity_fused,
                                                          self_similarity_fused_plain)
    from ffrnet_torch.ops.kernels.warp import (warp_affine_band, warp_affine_band_plain,
                                               warp_affine_full, warp_affine_full_plain)

    n = 256
    # ingest: host uint8 canvases of the fixture's face in, both embeddings
    # out (fused fp32)
    exp = np.load(GOLDEN)
    canvas = np.repeat(exp["decoded"][None], n, axis=0)
    lmk = exp["landmarks"].astype(np.float32) + np.random.default_rng(41).normal(
        0, 2, (n, 5, 2)).astype(np.float32)
    t = host_ms(lambda: models["fused"].embed_canvas(canvas, lmk), samples=10)
    log("times", f"ingest fused fp32 N={n} (250x250x3 uint8 -> 112x112 -> embed): median "
        f"{np.median(t):.3f} ms/batch (max {t.max():.3f}, 10 samples), "
        f"{n / np.median(t) * 1e3:.1f} faces/s | {card}")
    # its alignment alone: host cp2tform and guard, the uint8 upload, the
    # cast and the band kernel
    t = host_ms(lambda: models["fused"].align(canvas, lmk, out_hw=(112, 112),
                                              ref_pts=REF_PTS_112), samples=10)
    log("times", f"ingest's align alone N={n}: median {np.median(t):.3f} ms/batch (max "
        f"{t.max():.3f}, 10 samples) | {card}")
    # host uint8 faces, as a caller hands them over
    faces = torch.randint(0, 256, (n, 112, 112, 3), generator=gen(40),
                          dtype=torch.uint8).numpy()
    for name in ("fused", "ss_kernel"):
        for dname, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            m = models[name] if dt == torch.float32 else models[name].prepare(dtype=dt)
            if dt == torch.bfloat16:  # the reduced type keeps to the fp32 embedding
                ref = models[name].embed(faces[:64])[0]
                cos = torch.nn.functional.cosine_similarity(
                    m.embed(faces[:64])[0].float(), ref, dim=1).min().item()
                log("times", f"{name} bf16 vs fp32 raw embedding: min cosine {cos:.5f}")
            t = host_ms(lambda: m.embed(faces), samples=10)
            log("times", f"embed {name} {dname} N={n}: median {np.median(t):.3f} ms/batch "
                f"(max {t.max():.3f}, 10 samples), {n / np.median(t) * 1e3:.1f} faces/s "
                f"| {card}")
            if name == "fused":
                t1 = host_ms(lambda: m.embed(faces[:1]), samples=100, warmup=5)
                log("times", f"embed {name} {dname} N=1 latency: p50 {np.median(t1):.3f} ms, "
                    f"p90 {np.percentile(t1, 90):.3f} ms (100 samples) | {card}")
            del m
    g = gen(50)
    x_se = [(torch.randn(n, c, h, h, generator=g).to(dev),
             (0.2 * torch.randn(c // 16, c, generator=g)).to(dev),
             (0.2 * torch.randn(c, c // 16, generator=g)).to(dev), units)
            for h, c, units in SE_STAGES]

    def se_forward(fn):
        def run():
            for x, w1, w2, units in x_se:
                for _ in range(units):
                    fn(x, w1, w2)
        return run

    x_ss = torch.randn(n, 512, 7, 7, generator=g).to(dev)
    flat = torch.randn(n, 512, 49, generator=g).to(dev)
    w_cb = c4c_weights(models["fused"], 51, True, dev)
    imgs = (255 * torch.rand(n, 250, 250, 3, generator=g)).to(dev)
    lmk = face_landmarks(n, 52)
    mats = warp_mats(lmk, REF_PTS_112).to(dev)
    cw = auto_band_crop_w(lmk, REF_PTS_112, (250, 250), 112)
    f32 = torch.float32
    runs = {"se_gating": (se_forward(se_gating), se_forward(se_gating_plain),
                          "24 gates of one IR-SE50 forward"),
            "self_similarity": (lambda: self_similarity_fused(x_ss),
                                lambda: self_similarity_fused_plain(x_ss), "(256,512,7,7)"),
            "channel_branch": (lambda: channel_branch(flat, w_cb),
                               lambda: channel_branch_plain(flat, w_cb), "(256,512,49)"),
            "warp_affine_full": (
                lambda: warp_affine_full(imgs, mats, out_hw=(112, 112), compute_dtype=f32),
                lambda: warp_affine_full_plain(imgs, mats, out_hw=(112, 112), compute_dtype=f32),
                "(256,250,250,3) -> 112x112, fp32 compute"),
            "warp_affine_band": (
                lambda: warp_affine_band(imgs, mats, out_hw=(112, 112), crop_w=cw),
                lambda: warp_affine_band_plain(imgs, mats, out_hw=(112, 112), crop_w=cw),
                f"(256,250,250,3) -> 112x112, crop_w {cw} (guard)")}
    bound = bounds(n)
    times = {}
    for k, (kern, plain, what) in runs.items():
        # plain, kernel, kernel, plain: the two versions in turns
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
        times[k] = (min(k1, k2), min(p1, p2))
        log("times", f"{k} fp32 {what}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} "
            f"ms, bound {bound[k][0]:.4f} ms ({bound[k][1]}) | {card}")
    se_times(x_se, n, card)
    cb_times(flat, w_cb, n, card)
    ss_times(x_ss, n, card)
    # the library's bilinear zero-border warp on an NCHW copy made here,
    # outside the timed region; first held against the plain warp
    x_nchw = imgs.permute(0, 3, 1, 2).contiguous()
    theta = grid_sample_theta(mats, (250, 250), (112, 112))
    fn = torch.nn.functional

    def library():
        grid = fn.affine_grid(theta, (n, 3, 112, 112), align_corners=True)
        return fn.grid_sample(x_nchw, grid, mode="bilinear", padding_mode="zeros",
                              align_corners=True)

    e = check_close("F.grid_sample vs the plain warp", library().permute(0, 2, 3, 1),
                    warp_affine_full_plain(imgs, mats, out_hw=(112, 112), compute_dtype=f32),
                    *LIBRARY_WARP_TOL)
    lib = min(cuda_ms(library), cuda_ms(library))
    log("times", f"library F.affine_grid + F.grid_sample (NCHW) same warp: {lib:.4f} ms "
        f"(max_abs_err {e:.3e} vs the plain warp, tol {LIBRARY_WARP_TOL[0]}) | {card}")
    return times, bound, {k: lib for k in WARPS}


def cb_times(flat, w_cb, n, card):
    """channel_branch alone at (n, 512, 49), device time from CUDA graphs,
    in fp32 and in bf16 (fp32, bf16, bf16, fp32), each beside its bound."""
    from ffrnet_torch.ops.kernels.channel_branch import channel_branch

    flat_bf = flat.bfloat16()
    f1, b1, b2, f2 = (graph_ms(lambda: channel_branch(flat, w_cb)),
                      graph_ms(lambda: channel_branch(flat_bf, w_cb)),
                      graph_ms(lambda: channel_branch(flat_bf, w_cb)),
                      graph_ms(lambda: channel_branch(flat, w_cb)))
    (f32, by32), (b16, by16) = cb_bound(n, 4), cb_bound(n, 2)
    simt = roof(0, n * (2 * 32 * 512 * 49 + 4 * 512 * 32 * 49 + 4 * 512 * 32 * 32
                        + 2 * 512 * 512 * (32 + 49)))[0]
    log("times", f"channel_branch ({n},512,49), device (graph): fp32 {f1:.4f}/{f2:.4f} ms, bound "
        f"{f32:.4f} ms ({by32}; {100 * f32 / min(f1, f2):.0f}%), every operation on fp32 SIMT "
        f"{simt:.4f} ms; bf16 {b1:.4f}/{b2:.4f} ms, bound {b16:.4f} ms ({by16}; "
        f"{100 * b16 / min(b1, b2):.0f}%) | {card}")


def ss_times(x_ss, n, card):
    """self_similarity alone at (n, 512, 7, 7) in fp32 and in bf16 (fp32,
    bf16, bf16, fp32): the wrapper's call timed with CUDA events ("host")
    and a CUDA-graph replay of it ("device"), each beside its bound. Beside
    it, as a yardstick and not as the same function (no norms, no ss_space,
    the whole Gram where the kernel computes half): torch.bmm(x, x^T) for
    the unscaled channel Gram in fp32, TF32 off."""
    from ffrnet_torch.ops.kernels.self_similarity import self_similarity_fused

    x_bf = x_ss.bfloat16()
    runs = {"fp32": lambda: self_similarity_fused(x_ss),
            "bf16": lambda: self_similarity_fused(x_bf)}
    t = {k: [] for k in runs}
    for k in ("fp32", "bf16", "bf16", "fp32"):
        t[k].append((cuda_ms(runs[k]), graph_ms(runs[k])))
    (f32, by32), (b16, by16) = ss_bound(n, 4), ss_bound(n, 2)
    # bf16's products run on the tensor cores, where the bytes bound it
    b16_bytes = roof(n * 512 * 49 * 2 + n * (49 * 49 + 512 * 512) * 2, 0)[0]
    fmt = {k: (f"host {v[0][0]:.4f}/{v[1][0]:.4f} ms, device {v[0][1]:.4f}/{v[1][1]:.4f} ms",
               min(v[0][1], v[1][1])) for k, v in t.items()}
    log("times", f"self_similarity ({n},512,7,7): fp32 {fmt['fp32'][0]}, bound {f32:.4f} ms "
        f"({by32}; {100 * f32 / fmt['fp32'][1]:.0f}% of device); bf16 {fmt['bf16'][0]}, bound "
        f"{b16:.4f} ms ({by16} on fp32 SIMT; {100 * b16 / fmt['bf16'][1]:.0f}%), "
        f"{b16_bytes:.4f} ms by bytes with the products on the tensor cores "
        f"({100 * b16_bytes / fmt['bf16'][1]:.0f}%) | {card}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    flat = x_ss.reshape(n, 512, 49)
    gram = (lambda: torch.bmm(flat, flat.transpose(1, 2)))
    host = min(cuda_ms(gram), cuda_ms(gram))
    dev = min(graph_ms(gram), graph_ms(gram))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    log("times", f"yardstick torch.bmm(x, x^T) ({n},512,49) fp32 TF32 off, the unscaled "
        f"channel Gram alone: {host:.4f} ms host, {dev:.4f} ms device (graph) | {card}")


def se_times(x_se, n, card):
    """The SE gates alone at batch n, device time from CUDA graphs (a small
    gate's launch costs the host more than the card): the 24 gates of a
    forward and each IR-SE50 stage's gate, in fp32 and in bf16, each beside
    its bound. bf16 runs in turns with the plan's clusters (four CTAs an SM,
    fp32's cluster sizes) and with slices twice the bytes (two CTAs an SM,
    half the CTAs)."""
    from ffrnet_torch.ops.kernels.se_gating import _launch, _se_plan

    def gates(stages, ctas_per_sm=None):
        plans = [_se_plan(x.shape[1], x.shape[2] * x.shape[3], w1.shape[0], x.element_size(),
                          ctas_per_sm) for x, w1, _, _ in stages]

        def run():
            for (x, w1, w2, units), plan in zip(stages, plans):
                for _ in range(units):
                    _launch(x, w1, w2, plan)
        return run

    def bf16_pair(stages, iters):
        """(plan, plan, two CTAs/SM, two CTAs/SM) in turns."""
        plan, two = gates(stages), gates(stages, 2)
        t1, s1, s2, t2 = (graph_ms(plan, iters), graph_ms(two, iters), graph_ms(two, iters),
                          graph_ms(plan, iters))
        return f"{t1:.4f}/{t2:.4f} ms (two CTAs/SM {s1:.4f}/{s2:.4f} ms)", min(t1, t2)

    bf = [(x.bfloat16(), w1.bfloat16(), w2.bfloat16(), units) for x, w1, w2, units in x_se]
    f32 = graph_ms(gates(x_se), iters=5)
    b32, b16 = se_bound(n, 4), se_bound(n, 2)
    text, t16 = bf16_pair(bf, 5)
    log("times", f"se_gating 24 gates of one IR-SE50 forward, device (graph): fp32 {f32:.4f} ms, "
        f"bound {b32[0]:.4f} ms ({100 * b32[0] / f32:.0f}%); bf16 {text}, bound {b16[0]:.4f} ms "
        f"({100 * b16[0] / t16:.0f}%) | {card}")
    for (h, c, _), one, one_bf in zip(SE_STAGES, x_se, bf):
        f32 = graph_ms(gates([one[:3] + (1,)]), 20)
        b32, b16 = se_bound(n, 4, ((h, c, 1),)), se_bound(n, 2, ((h, c, 1),))
        text, t16 = bf16_pair([one_bf[:3] + (1,)], 20)
        log("times", f"se_gating one gate ({n},{c},{h},{h}), device (graph): fp32 {f32:.4f} ms, "
            f"bound {b32[0]:.4f} ms ({100 * b32[0] / f32:.0f}%); bf16 {text}, bound "
            f"{b16[0]:.4f} ms ({100 * b16[0] / t16:.0f}%) | {card}")


# ------------------------------------------------------------------ phase 8

# card vs CPU after one SGD update (lr 1e-2): the losses within 1e-4
# (fp32, TF32 off, convolutions summed in other orders through 49 + 15
# conv layers); each parameter moves by lr * g, and g is
# about 1e-4 relative apart where the BN cancels a large common offset,
# so the parameters within 1e-5 (tenfold margin over lr * 1e-4 * |g|max)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-5
TRAIN_CONFIGS = ("fused", "ss_kernel")


def train_cfg(name, num_classes=10575, **kw):
    from dataclasses import replace

    from ffrnet_torch.models.recnet import SS_KERNEL_CONFIG, RecNetConfig
    from ffrnet_torch.training.trainer import TrainerConfig

    rec = SS_KERNEL_CONFIG if name == "ss_kernel" else RecNetConfig()
    return TrainerConfig(recnet=replace(rec, num_classes=num_classes), **kw)


def image_batch(n, seed, num_classes=10575):
    g = gen(seed)
    return {"img_non": torch.randint(0, 256, (n, 112, 112, 3), generator=g, dtype=torch.uint8),
            "img_ocl": torch.randint(0, 256, (n, 112, 112, 3), generator=g, dtype=torch.uint8),
            "label": torch.randint(0, num_classes, (n,), generator=g)}


def train_grad_checks(model, dev):
    """Each kernel Function vs autograd through its plain twin on the same
    inputs: the forward within the kernel's tolerance, the gradients equal
    to the bit (the backward recomputes the twin from the saved inputs)."""
    from ffrnet_torch.ops.kernels.channel_branch import channel_branch, channel_branch_plain
    from ffrnet_torch.ops.kernels.se_gating import se_gating, se_gating_plain
    from ffrnet_torch.ops.kernels.self_similarity import (self_similarity_fused,
                                                          self_similarity_fused_plain)

    g = gen(80)
    n = 64
    w_cb = c4c_weights(model, 80, True, "cpu")
    for dname, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        cases = [("self_similarity", (torch.randn(n, 512, 7, 7, generator=g),),
                  self_similarity_fused, self_similarity_fused_plain)]
        for h, c, _ in SE_STAGES:
            cases.append((f"se_gating ({n},{c},{h},{h})",
                          (torch.randn(n, c, h, h, generator=g),
                           0.2 * torch.randn(c // 16, c, generator=g),
                           0.2 * torch.randn(c, c // 16, generator=g)), se_gating, se_gating_plain))
        cases.append(("channel_branch", (torch.randn(n, 512, 49, generator=g), *w_cb),
                      lambda f, *w: channel_branch(f, w), lambda f, *w: channel_branch_plain(f, w)))
        for what, host, kern, plain in cases:
            # channel_branch's weights stay fp32 in both types
            args = [t.to(dev, dt if i == 0 or not what.startswith("channel") else torch.float32)
                    for i, t in enumerate(host)]
            outs, grads = [], []
            for fn in (kern, plain):
                leaves = [a.detach().clone().requires_grad_() for a in args]
                out = fn(*leaves)
                out = out if isinstance(out, tuple) else (out,)
                cot = [torch.randn(o.shape, generator=gen(81)).to(dev, o.dtype) for o in out]
                grads.append(torch.autograd.grad(out, leaves, cot))
                outs.append(out)
            tol = TOL.get((dname, what.split(" ")[0]), BF16_TOL)
            err = max(check_close(f"train grad check {what} {dname} forward", a, b, *tol)
                      for a, b in zip(*outs))
            for i, (a, b) in enumerate(zip(*grads)):
                if not torch.equal(a, b):
                    raise AssertionError(f"train grad check {what} {dname}: input {i}'s gradient "
                                         f"{(a.float() - b.float()).abs().max().item():.3e} off "
                                         f"the plain twin's")
            log("train", f"{what} {dname}: forward max_abs_err {err:.3e} (tol {tol[0]}), "
                f"gradients of {len(args)} inputs equal to the plain twin's autograd")
    torch.cuda.synchronize()


def train_cpu_parity(dev):
    """One train_step (N=4, uint8 images, SGD lr 1e-2) on the card and on
    the CPU from the same weights, in both configurations."""
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.training.trainer import create_train_state, train_step

    enc_cpu = build_backbone(generator=gen(0))
    enc_dev = build_backbone(generator=gen(0), device=dev)
    batch = image_batch(4, 82)
    for name in TRAIN_CONFIGS:
        cfg = train_cfg(name, optimizer="sgd", lr=1e-2, momentum=0.0)
        runs = []
        for enc, where in ((enc_dev, dev), (enc_cpu, "cpu")):
            state = create_train_state(cfg, seed=1, device=where)
            state, m = train_step(enc, state, batch, cfg=cfg)
            runs.append(({k: float(v) for k, v in m.items()},
                         {k: v.cpu() for k, v in state.model.state_dict().items()}))
        (m_card, sd_card), (m_cpu, sd_cpu) = runs
        for k in m_cpu:
            if not np.isfinite(m_card[k]) or abs(m_card[k] - m_cpu[k]) > (
                    TRAIN_LOSS_RTOL * abs(m_cpu[k]) + 1e-6):
                raise AssertionError(f"train {name}: {k} card {m_card[k]} vs CPU {m_cpu[k]}")
        p_err = max(check_close(f"train {name}: {k} card vs CPU", sd_card[k], sd_cpu[k],
                                TRAIN_PARAM_ATOL, 0) for k in sd_cpu if "running" not in k)
        s_err = max(check_close(f"train {name}: {k} card vs CPU", sd_card[k], sd_cpu[k], 1e-5,
                                TRAIN_LOSS_RTOL) for k in sd_cpu if "running" in k)
        log("train", f"{name}: one train_step N=4, 10575 classes, card vs CPU: TotalLoss "
            f"{m_card['TotalLoss']:.6f} / {m_cpu['TotalLoss']:.6f} (rtol {TRAIN_LOSS_RTOL}); "
            f"parameters max_abs_err {p_err:.3e} (atol {TRAIN_PARAM_ATOL}); running stats "
            f"{s_err:.3e}")


def train_counts(dev):
    """Launches of one train_step and one train_step_from_features (N=8)
    per configuration, the counts set to 0 just before each."""
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
    from ffrnet_torch.training.trainer import (create_train_state, encode_frozen, train_step,
                                               train_step_from_features)

    enc = build_backbone(generator=gen(0), device=dev)
    batch = image_batch(8, 83)
    feats = encode_frozen(enc, batch)
    out = {}
    for name in TRAIN_CONFIGS:
        cfg = train_cfg(name, optimizer="adam", lr=1e-3)
        state = create_train_state(cfg, seed=1, device=dev)
        ss = 7 if name == "ss_kernel" else 0
        for what, fn, want in (
                ("train_step", lambda: train_step(enc, state, batch, cfg=cfg), 24),
                ("train_step_from_features",
                 lambda: train_step_from_features(state, feats, cfg=cfg), 0)):
            torch.cuda.synchronize()
            reset_launch_counts()
            fn()
            torch.cuda.synchronize()
            c = launch_counts()
            expected = {"se_gating": want, "self_similarity": ss, "channel_branch": 0,
                        "warp_affine_full": 0, "warp_affine_band": 0, "int8_conv": 0}
            if c != expected:
                raise AssertionError(f"train {name} {what}: launches {c}, expected {expected}")
            out[name, what] = c
            log("counts", f"train {name}: one {what} -> {c}")
    return out


def train_convergence(dev):
    """tests/test_training.py's convergence protocol on the card, full
    batch: 64 SyntheticPairs identities (seed 3), features encoded once,
    Adam lr 1e-3, batch 64 drawn by rng(1), until TrainAcc > 0.95 with a
    triplet gap > 0.09 after at least 30 steps, at most 300."""
    from ffrnet_torch.data.datasets import SyntheticPairs
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.training.trainer import (create_train_state, encode_frozen,
                                               train_step_from_features)

    n_ids = 64
    ds = SyntheticPairs(num_identities=n_ids, samples_per_id=1, seed=3)
    rng = np.random.default_rng(0)
    samples = [ds.get(i, rng) for i in range(len(ds))]
    batch = {k: np.stack([s[k] for s in samples]) for k in ("img_non", "img_ocl", "label")}
    feats = encode_frozen(build_backbone(generator=gen(0), device=dev), batch)
    for name in TRAIN_CONFIGS:
        cfg = train_cfg(name, num_classes=n_ids, optimizer="adam", lr=1e-3)
        state = create_train_state(cfg, seed=1, device=dev)
        order = np.random.default_rng(1)
        curve = []
        t0 = time.perf_counter()
        for it in range(300):
            idx = torch.from_numpy(order.choice(n_ids, 64, replace=False)).to(dev)
            state, m = train_step_from_features(
                state, {k: v[idx] for k, v in feats.items()}, cfg=cfg)
            m = {k: float(v) for k, v in m.items()}
            curve.append((m["TrainAcc"], m["NegDist"] - m["PosDist"], m["TotalLoss"]))
            if m["TrainAcc"] > 0.95 and curve[-1][1] > 0.09 and it + 1 >= 30:
                break
        (acc0, gap0, loss0), (acc, gap, loss) = curve[0], curve[-1]
        if not (acc > 0.9 and gap > 0.01 and gap > gap0 + 0.01 and loss < loss0 / 2):
            raise AssertionError(f"train {name}: did not converge in {len(curve)} steps: "
                                 f"first {curve[0]}, last {curve[-1]}")
        log("train", f"{name}: converged in {len(curve)} steps ({time.perf_counter() - t0:.1f} s): "
            f"TrainAcc {acc0:.3f} -> {acc:.3f}, triplet gap {gap0:+.4f} -> {gap:+.4f}, "
            f"TotalLoss {loss0:.3f} -> {loss:.3f}")


def train_times(dev, card):
    """Step ms (median of 10 after 3 warm-up, CUDA events around each step)
    and train imgs/s at N=128, 10575 classes, Adam, in both configurations,
    fp32 and bf16, for train_step and train_step_from_features; then the
    self_similarity Function's forward (the kernel) and backward (the twin's
    VJP, with both Grams read or one) at (128, 512, 7, 7) fp32."""
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.ops.kernels.self_similarity import self_similarity_fused
    from ffrnet_torch.tools.bench_train import step_times
    from ffrnet_torch.training.trainer import (create_train_state, encode_frozen, train_step,
                                               train_step_from_features)

    n = 128
    enc32 = build_backbone(generator=gen(0), device=dev)
    g = gen(84)
    batch = {"img_non": (torch.rand(n, 112, 112, 3, generator=g) * 2 - 1).to(dev),
             "img_ocl": (torch.rand(n, 112, 112, 3, generator=g) * 2 - 1).to(dev),
             "label": torch.randint(0, 10575, (n,), generator=g).to(dev)}
    for dname in ("fp32", "bf16"):
        enc = enc32 if dname == "fp32" else build_backbone(generator=gen(0), device=dev).to(
            torch.bfloat16)
        feats = encode_frozen(enc, batch)
        for name in TRAIN_CONFIGS:
            cfg = train_cfg(name, optimizer="adam", lr=1e-3, compute_dtype=dname)
            state = create_train_state(cfg, seed=1, device=dev)
            torch.cuda.reset_peak_memory_stats()
            for what, fn in (("train_step", lambda: train_step(enc, state, batch, cfg=cfg)),
                             ("train_step_from_features",
                              lambda: train_step_from_features(state, feats, cfg=cfg))):
                ms, m = step_times(fn, 10)
                if not np.isfinite(float(m["TotalLoss"])):
                    raise AssertionError(f"train times {name} {dname} {what}: non-finite loss")
                med = float(np.median(ms))
                log("times", f"train {name} {dname} {what} N={n}: step median {med:.3f} ms "
                    f"(min {min(ms):.3f}, max {max(ms):.3f}, 10 steps), {n / med * 1e3:.1f} "
                    f"train imgs/s | {card}")
            log("times", f"train {name} {dname}: peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            del state
        del feats
    x = torch.randn(n, 512, 7, 7, generator=g).to(dev).requires_grad_()
    cot = (torch.randn(n, 49, 49, generator=g).to(dev), torch.randn(n, 512, 512, generator=g).to(dev))

    def fwd_bwd(read):
        def run():
            out = self_similarity_fused(x)
            torch.autograd.grad([o for o, r in zip(out, read) if r], x,
                                [c for c, r in zip(cot, read) if r])
        return run

    with torch.no_grad():
        fwd = min(cuda_ms(lambda: self_similarity_fused(x)),
                  cuda_ms(lambda: self_similarity_fused(x)))
    bwd = {read: min(cuda_ms(fwd_bwd(read)), cuda_ms(fwd_bwd(read))) - fwd
           for read in ((True, True), (True, False), (False, True))}
    log("times", f"self_similarity Function ({n},512,7,7) fp32: forward (the kernel) {fwd:.4f} ms; "
        f"backward (the twin's VJP, forward+backward less forward) {bwd[True, True]:.4f} ms with "
        f"both Grams read, {bwd[True, False]:.4f} ms with ss_space alone, "
        f"{bwd[False, True]:.4f} ms with ss_channel alone | {card}")


def phase_train(model, dev, card):
    t0 = time.perf_counter()
    train_grad_checks(model, dev)
    train_cpu_parity(dev)
    counts = train_counts(dev)
    train_convergence(dev)
    train_times(dev, card)
    log("train", f"all training checks passed in {time.perf_counter() - t0:.1f} s")
    return counts


# ------------------------------------------------------------------ phase 9

DRIVER_IDS, DRIVER_PER_ID, DRIVER_PAIRS, DRIVER_BATCH, DRIVER_CLASSES = 64, 4, 600, 64, 10575
# launches per driver call: a raw-image train_step (one 2N encoder pass), a
# cached step (RecNet alone; self_similarity 2 forwards + 5 loss Grams in the
# kernel configuration), a 2B eval batch (encoder + RecNet in eval)
DRIVER_COUNTS = {
    ("fused", "train_step"): {"se_gating": 24},
    ("ss_kernel", "train_step_from_features"): {"self_similarity": 7},
    ("fused", "eval"): {"se_gating": 24, "channel_branch": 1},
    ("ss_kernel", "eval"): {"se_gating": 24, "self_similarity": 1},
}


def driver_tree(root):
    """CASIA-like and LFW-like in one tree: 64 identities x 4 aligned
    112x112 JPEGs, each with its masked twin (`_m`, a lower-face box set
    dark), a CASIA list over all 256 and 600 LFW pairs (300 same, 300
    different) over the same faces. Smooth per-identity templates, made
    from seed 90."""
    from PIL import Image

    rng = np.random.default_rng(90)
    lines = []
    for i in range(DRIVER_IDS):
        name = f"id_{i:03d}"
        os.makedirs(os.path.join(root, name))
        small = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        base = np.asarray(Image.fromarray(small).resize((112, 112), Image.BICUBIC), np.int16)
        for k in range(1, DRIVER_PER_ID + 1):
            img = np.clip(base + rng.integers(-12, 13, base.shape), 0, 255).astype(np.uint8)
            stem = os.path.join(root, name, f"{name}_{k:04d}")
            Image.fromarray(img).save(stem + ".jpg", quality=90)
            img[60:100, 20:92] = 20
            Image.fromarray(img).save(stem + "_m.jpg", quality=90)
            lines.append(f"{name}/{name}_{k:04d}.jpg {i}\n")
    with open(os.path.join(root, "list.txt"), "w") as f:
        f.writelines(lines)
    pairs = [f"10\t{DRIVER_PAIRS // 2}\n"]
    for p in range(DRIVER_PAIRS // 2):
        i, j = p % DRIVER_IDS, (p * 7 + 3) % DRIVER_IDS
        a, b = 1 + p % DRIVER_PER_ID, 1 + (p + 1) % DRIVER_PER_ID
        pairs.append(f"id_{i:03d}\t{a}\t{b}\n")
        pairs.append(f"id_{i:03d}\t{a}\tid_{j if j != i else (i + 1) % DRIVER_IDS:03d}\t{b}\n")
    with open(os.path.join(root, "pairs.txt"), "w") as f:
        f.writelines(pairs)


def driver_argv(tree, weight_root, *extra):
    return ["--phase", "train", "--train_data", tree,
            "--train_img_list", os.path.join(tree, "list.txt"), "--test_data", tree,
            "--test_pair_list", os.path.join(tree, "pairs.txt"),
            "--num_classes", str(DRIVER_CLASSES), "--batch_size", str(DRIVER_BATCH), "--total_epochs", "2", "--save_freq", "4",
            "--eval_freq", "4",
            "--print_freq", "4", "--optimizer", "Adam", "--lr", "1e-3", "--nThread", "8",
            "--seed", "0", "--encoder_weights", "", "--weight_root", weight_root, *extra]


class DriverProbe:
    """Wraps the calls the driver (ffrnet_torch.train) makes through its
    module's names, and records each one: a train step's and an eval batch's
    kernel launches (the counts set to 0 just before the call and read
    just after) and host milliseconds (synchronized), each checkpoint
    write's milliseconds, the feature-cache build, and the driver Timer's
    sections. `close()` puts the driver's own names back."""

    def __init__(self):
        import ffrnet_torch.train as T
        from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
        from ffrnet_torch.training import feature_cache as FC

        self.steps, self.evals, self.saves, self.sections, self.builds = [], [], [], [], []
        self._undo = []
        probe = self

        def counted(fn, sink):
            def run(*a, **k):
                torch.cuda.synchronize()
                reset_launch_counts()
                t = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                sink.append(((time.perf_counter() - t) * 1e3, launch_counts()))
                return out
            return run

        class RecordingTimer(T.Timer):
            def update_time(self, name):
                super().update_time(name)
                probe.sections.append((name, self._sections[name]))

        score_fn = T.make_pair_score_fn
        self._set(T, "train_step", counted(T.train_step, self.steps))
        self._set(T, "train_step_from_features", counted(T.train_step_from_features, self.steps))
        self._set(T, "make_pair_score_fn", lambda enc, rec: counted(score_fn(enc, rec), self.evals))
        self._set(T, "save_checkpoint", counted(T.save_checkpoint, self.saves))
        self._set(T, "Timer", RecordingTimer)
        self._set(FC, "build_feature_cache", counted(FC.build_feature_cache, self.builds))

    def _set(self, mod, name, value):
        self._undo.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    def close(self):
        for mod, name, value in reversed(self._undo):
            setattr(mod, name, value)

    def reset(self):
        for sink in (self.steps, self.evals, self.saves, self.sections, self.builds):
            sink.clear()

    def step_stats(self):
        """(steps/s from the median of the steps after the first, DataTime
        share of the Timer's sections after the first step)."""
        ms = [m for m, _ in self.steps[1:]]
        first = next(i for i, (n, _) in enumerate(self.sections) if n == "Step")
        later = self.sections[first + 1:]
        data = sum(s for n, s in later if n == "DataTime")
        return 1e3 / float(np.median(ms)), data / sum(s for _, s in later)


def check_driver_counts(what, records, want):
    expected = {k: want.get(k, 0) for k in KERNELS}
    for i, (_, c) in enumerate(records):
        if c != expected:
            raise AssertionError(f"driver {what} #{i}: launches {c}, expected {expected}")
    log("driver", f"{what}: {len(records)} calls, each {expected}")


def read_scalars(opts):
    with open(os.path.join(opts.log_dir, opts.save_weight_dir, "all_scalars.json")) as f:
        return json.load(f)


def driver_runs(probe, tree, root, card):
    """The fp32 fused run, its resume, the bf16 cached ss_kernel run and
    --phase test, through train.main; returns the fp32 run's options."""
    import shutil

    import ffrnet_torch.train as T
    from ffrnet_torch.checkpoint.store import load_checkpoint
    from ffrnet_torch.config import parse_args

    # fp32, the fused configuration: 256 samples, batch 64, 2 epochs = 8 steps
    argv = driver_argv(tree, os.path.join(root, "fp32"))
    opts = parse_args(argv, make_dirs=False)
    T.main(argv)
    ckpts = sorted(n for n in os.listdir(opts.ckpt_dir) if n.endswith(".pth.gzip"))
    if ckpts != ["0000004.pth.gzip", "0000008.pth.gzip", "latest.pth.gzip"]:
        raise AssertionError(f"driver fp32: checkpoints {ckpts}")
    meta = load_checkpoint(opts.ckpt_dir, "latest")[2]
    if meta != {"epoch": 1, "iter": 8}:
        raise AssertionError(f"driver fp32: latest meta {meta}")
    scalars = read_scalars(opts)
    for ocl in range(3):
        iters = scalars.get(f"test_acc/ocl{ocl}/acc", {}).get("iters")
        if iters != [4, 8]:
            raise AssertionError(f"driver fp32: eval ocl{ocl} at iterations {iters}, not [4, 8]")
    losses = scalars["train_values/TotalLoss"]["values"]
    check_driver_counts("fp32 fused train_step", probe.steps, DRIVER_COUNTS["fused", "train_step"])
    check_driver_counts("fp32 fused eval batch", probe.evals, DRIVER_COUNTS["fused", "eval"])
    sps32, share32 = probe.step_stats()
    save_ms = [m for m, _ in probe.saves]
    log("driver", f"fp32 fused: 8 steps, TotalLoss {losses[0]:.3f} -> {losses[-1]:.3f}; "
        f"checkpoints {ckpts}, latest {meta}; eval at iterations 4 and 8 over ocl 0/1/2; "
        f"acc_new ocl0 {scalars['test_acc/ocl0/acc_new']['values']}")

    # resume from the numbered checkpoint of iteration 4 in a fresh root
    probe.reset()
    argv_r = driver_argv(tree, os.path.join(root, "resume"), "--continue_train", "1",
                         "--which_file", "0000004")
    opts_r = parse_args(argv_r)
    shutil.copy(os.path.join(opts.ckpt_dir, "0000004.pth.gzip"), opts_r.ckpt_dir)
    T.main(argv_r)
    meta_r = load_checkpoint(opts_r.ckpt_dir, "latest")[2]
    if meta_r != {"epoch": 1, "iter": 8} or len(probe.steps) != 4:
        raise AssertionError(f"driver resume: latest meta {meta_r}, {len(probe.steps)} steps")
    check_driver_counts("fp32 resumed train_step", probe.steps,
                        DRIVER_COUNTS["fused", "train_step"])
    a, b = (load_checkpoint(o.ckpt_dir, "latest")[0] for o in (opts, opts_r))
    diff = max((a[k].float() - b[k].float()).abs().max().item() for k in a)
    log("driver", f"resumed from 0000004 in a fresh root: steps 5-8, latest {meta_r}; largest "
        f"difference from the uninterrupted run {diff:.3e} (reported only: cuDNN's backward "
        "is not deterministic)")

    # bf16, the self-similarity kernel configuration, from the feature cache
    probe.reset()
    argv_c = driver_argv(tree, os.path.join(root, "bf16"), "--compute_dtype", "bf16",
                         "--ss_impl", "pallas", "--cache_features", "1", "--eval_freq", "8")
    opts_c = parse_args(argv_c, make_dirs=False)
    T.main(argv_c)
    with open(os.path.join(opts_c.ckpt_dir, "feature_cache", "meta.json")) as f:
        cmeta = json.load(f)
    if cmeta["n"] != DRIVER_IDS * DRIVER_PER_ID or cmeta["compute_dtype"] != "bf16":
        raise AssertionError(f"driver bf16: feature cache meta {cmeta}")
    (build_ms, build_counts), = probe.builds
    check_driver_counts("bf16 feature-cache build", probe.builds,
                        {"se_gating": 2 * 24 * -(-cmeta["n"] // DRIVER_BATCH)})
    if load_checkpoint(opts_c.ckpt_dir, "latest")[2] != {"epoch": 1, "iter": 8}:
        raise AssertionError("driver bf16: latest meta")
    check_driver_counts("bf16 ss_kernel cached step", probe.steps,
                        DRIVER_COUNTS["ss_kernel", "train_step_from_features"])
    check_driver_counts("bf16 run's eval batch (fp32, ss_kernel)", probe.evals,
                        DRIVER_COUNTS["ss_kernel", "eval"])
    sps16, share16 = probe.step_stats()
    faces = 4 * cmeta["n"]  # clean and masked, unflipped and flipped
    log("driver", f"bf16 ss_kernel: cache of {cmeta['n']} samples built (24 se_gating launches "
        "per encoder pass, 2 passes per batch), then 8 cached steps")

    # --phase test on the fp32 checkpoint
    probe.reset()
    argv_t = [
        "--phase", "test", "--test_data", tree, "--test_pair_list",
        os.path.join(tree, "pairs.txt"), "--num_classes", str(DRIVER_CLASSES),
        "--batch_size", str(DRIVER_BATCH),
        "--nThread", "8", "--encoder_weights", "", "--weight_root", os.path.join(root, "fp32"),
        "--report_roc", "1", "--save_wrong", "1"]
    T.main(argv_t)
    scalars = read_scalars(opts)
    for ocl in range(3):
        for kind in ("new", "raw"):
            if f"test_roc_{kind}/ocl{ocl}/eer" not in scalars:
                raise AssertionError(f"driver test: no ROC for ocl{ocl} {kind}")
        for sub in ("wrong_images", "wrong_images_new"):
            if not os.path.isdir(os.path.join(opts.ckpt_dir, f"{sub}_ocl{ocl}")):
                raise AssertionError(f"driver test: no {sub}_ocl{ocl}")
    check_driver_counts("--phase test eval batch", probe.evals, DRIVER_COUNTS["fused", "eval"])
    log("driver", f"--phase test --report_roc 1 --save_wrong 1: ROC and wrong pairs for ocl 0/1/2; "
        f"ocl0 eer {scalars['test_roc_new/ocl0/eer']['values'][0]:.4f} (rectified)")

    n = DRIVER_BATCH
    log("times", f"driver fp32 fused N={n}: {sps32:.2f} steps/s ({sps32 * n:.1f} train imgs/s), "
        f"median of 7 steps after the first; DataTime share {share32:.1%} | {card}")
    log("times", f"driver bf16 ss_kernel cached N={n}: {sps16:.2f} steps/s ({sps16 * n:.1f} train "
        f"imgs/s); DataTime share {share16:.1%} | {card}")
    log("times", f"feature-cache build: {cmeta['n']} samples in {build_ms / 1e3:.2f} s, "
        f"{faces / build_ms * 1e3:.1f} faces encoded/s (bf16, clean + masked, both flips) | {card}")
    log("times", f"checkpoint save (RecNet with {DRIVER_CLASSES} classes and its Adam state, "
        ".pth.gzip): "
        f"median {np.median(save_ms):.1f} ms of {len(save_ms)} (min {min(save_ms):.1f}, max "
        f"{max(save_ms):.1f}) | {card}")
    return opts


def driver_card_vs_cpu(opts, dev, card):
    """Eval pairs/s at ocl 0 on the card (and its loader and scoring
    alone), the cache fingerprint's time, and the first eval batch's scores
    on the card against the CPU, from the fp32 run's latest checkpoint."""
    import ffrnet_torch.train as T
    from ffrnet_torch.checkpoint.store import load_checkpoint
    from ffrnet_torch.data.datasets import CasiaPairs
    from ffrnet_torch.eval.runner import make_pair_score_fn
    from ffrnet_torch.models.recnet import build_recnet
    from ffrnet_torch.training import feature_cache as fc

    sd = load_checkpoint(opts.ckpt_dir, "latest")[0]
    models = {}
    for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
        rec = build_recnet(opts.trainer_config().recnet)
        rec.load_state_dict(sd)
        models[key] = (T.load_encoder(opts, where), rec.to(where).eval())
    secs = []
    for _ in range(2):
        t = time.perf_counter()
        T.eval_lfw(opts, *models["card"], 0)
        secs.append(time.perf_counter() - t)
    # the eval's split: the loader alone (decode, upload), then the scoring
    # alone on batches already on the card
    t = time.perf_counter()
    on_card = list(T.make_eval_batches(opts, 0, opts.batch_size, device=dev)[0])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    score_fn = make_pair_score_fn(*models["card"])
    t = time.perf_counter()
    for b in on_card:
        score_fn(b["img1"], b["img2"])
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t
    t = time.perf_counter()
    fc.cache_fingerprint(CasiaPairs(opts.train_data, opts.train_img_list, use_native=False),
                         models["card"][0])
    fingerprint_s = time.perf_counter() - t
    batches, n_pairs = T.make_eval_batches(opts, 0, opts.batch_size)
    batch = next(batches)
    batches.close()
    card_s = make_pair_score_fn(*models["card"])(batch["img1"], batch["img2"])
    cpu_s = make_pair_score_fn(*models["cpu"])(batch["img1"], batch["img2"])
    errs = [check_close(f"driver eval batch {name} scores card vs CPU", a.cpu(), b, *PATH_TOL)
            for name, a, b in zip(("raw", "rectified"), card_s, cpu_s)]
    log("driver", f"first eval batch ({len(batch['label'])} pairs, fp32 checkpoint) card vs CPU: "
        f"raw scores max_abs_err {errs[0]:.3e}, rectified {errs[1]:.3e} (tol {PATH_TOL})")
    log("times", f"eval ocl 0, {n_pairs} pairs from JPEG files (decode, upload, 2B encoder + "
        f"RecNet, 10-fold sweep): {n_pairs / min(secs):.1f} pairs/s ({min(secs):.3f} s; "
        f"runs {', '.join(f'{s:.3f}' for s in secs)}); split: the loader alone (decode, upload) "
        f"{load_s:.3f} s, the scoring alone on batches on the card {score_s:.3f} s | {card}")
    log("times", f"feature-cache fingerprint alone (the encoder's state dict to the host, hashed; "
        f"the tree's sampled files): {fingerprint_s:.3f} s | {card}")


def phase_driver(dev, card):
    import tempfile

    t0 = time.perf_counter()
    probe = DriverProbe()
    try:
        with tempfile.TemporaryDirectory(prefix="ffrnet_driver_") as root:
            tree = os.path.join(root, "faces")
            driver_tree(tree)
            log("driver", f"tree: {DRIVER_IDS} identities x {DRIVER_PER_ID} JPEGs with masked twins "
                f"({time.perf_counter() - t0:.1f} s)")
            opts = driver_runs(probe, tree, root, card)
            probe.close()
            driver_card_vs_cpu(opts, dev, card)
    finally:
        probe.close()
    log("driver", f"all driver checks passed in {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------- phase 10

SERVE_CLIENTS = 16
SERVE_POOL = 64      # distinct faces the requests draw from
# bf16 served vs direct: cuDNN may plan each batch size differently, and
# every layer rounds to 8 mantissa bits, so rows are held by cosine
SERVE_BF16_MIN_COS = 0.999
VERIFY_TOL = (1e-5, 0.0)


def http_post(base, path, body, headers=None):
    req = urllib.request.Request(base + path, data=body, method="POST", headers=headers or {})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def http_get(base, path):
    with urllib.request.urlopen(base + path, timeout=120) as r:
        return r.read()


def serve_check(what, got, want, bf16):
    """got, want: (2, k, 512) raw and rectified rows -> the worst error
    (fp32: max abs error within PATH_TOL; bf16: 1 - min cosine)."""
    got, want = torch.from_numpy(got.copy()), torch.from_numpy(want)
    if not bf16:
        return check_close(what, got, want, *PATH_TOL)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=2).min().item()
    if not cos >= SERVE_BF16_MIN_COS:
        raise AssertionError(f"{what}: min cosine {cos:.6f} below {SERVE_BF16_MIN_COS}")
    return 1.0 - cos


def serve_load(base, pool_u8, want, seconds, clients, bf16, seed):
    """`clients` closed-loop threads POST /embed for `seconds`: groups of
    1-8 faces of the pool as float32 or uint8 bodies, each response held
    against the direct embed of the same faces. -> (faces, requests, wall
    seconds, worst error)."""
    pool_f32 = (pool_u8.astype(np.float32) / 255.0 - 0.5) / 0.5  # the card's bits
    stop = time.monotonic() + seconds
    lock, tally, failures = threading.Lock(), [0, 0, 0.0], []

    def client(c):
        rng = np.random.default_rng(seed + c)
        faces = requests = 0
        worst = 0.0
        try:
            while time.monotonic() < stop:
                k = int(rng.integers(1, 9))
                i = int(rng.integers(0, len(pool_u8) - k + 1))
                if rng.integers(0, 2):
                    body, hdr = pool_u8[i:i + k].tobytes(), {"X-Input-Dtype": "uint8"}
                else:
                    body, hdr = pool_f32[i:i + k].astype("<f4").tobytes(), {}
                out = np.frombuffer(http_post(base, "/embed", body, hdr), "<f4")
                worst = max(worst, serve_check(f"/embed faces {i}:{i + k}",
                                               out.reshape(2, k, 512), want[:, i:i + k], bf16))
                faces, requests = faces + k, requests + 1
        except Exception as e:  # noqa: BLE001 — raised below, after the join
            failures.append(e)
        with lock:
            tally[0] += faces
            tally[1] += requests
            tally[2] = max(tally[2], worst)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(seconds + 120)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("serve: a client thread did not finish")
    if failures:
        raise failures[0]
    return tally[0], tally[1], wall, tally[2]


def single_face_latency(base, pool_u8, samples):
    """Host ms of `samples` single-face uint8 /embed requests at one client."""
    out = []
    for i in range(samples):
        body = pool_u8[i % len(pool_u8)][None].tobytes()
        t = time.perf_counter()
        http_post(base, "/embed", body, {"X-Input-Dtype": "uint8"})
        out.append((time.perf_counter() - t) * 1e3)
    return np.asarray(out)


def check_serve_counts(name, counts, batches, kernel, int8_sites=0):
    expected = {k: 0 for k in KERNELS}
    expected["se_gating"] = 24 * batches
    expected[kernel] = batches
    expected["int8_conv"] = int8_sites * batches
    if counts != expected:
        raise AssertionError(f"serve {name}: launch counts {counts}, expected {expected} for "
                             f"{batches} dispatched batches")
    int8 = f" and {int8_sites} int8_conv" if int8_sites else ""
    log("serve", f"{name}: {batches} dispatched batches -> {counts} (24 se_gating{int8} and "
        f"one {kernel} per batch)")


def check_stats(name, base, svc, faces, requests):
    """/stats against what the clients sent and what the collector
    dispatched (each batch padded to its bucket)."""
    stats = json.loads(http_get(base, "/stats"))
    sizes = list(svc.stats.batch_sizes)
    padded = sum(next(b for b in svc._buckets if b >= s) - s for s in sizes)
    want = {"requests": requests, "faces": faces, "batches": len(sizes), "errors": 0,
            "padded_faces": padded}
    if {k: stats[k] for k in want} != want or len(sizes) != svc.stats.batches:
        raise AssertionError(f"serve {name}: /stats {stats}, expected {want}")
    return stats


def serve_gallery(base, srv, svc, pool_u8):
    """/enroll the pool under 64 labels, /identify the same faces with k=5:
    rank 1 must be each face's own label. Then a server warm-started from
    the gallery with face 7 enrolled again (a bit-equal row) must rank the
    two by index. -> (faces, requests) sent."""
    from ffrnet_torch.eval.search import Gallery
    from ffrnet_torch.serving import EmbeddingHTTPServer

    labels = [f"id{i:02d}" for i in range(len(pool_u8))]
    u8 = {"X-Input-Dtype": "uint8"}
    r = json.loads(http_post(base, "/enroll", pool_u8.tobytes(), {**u8, "X-Labels": ",".join(labels)}))
    if r != {"enrolled": len(labels), "gallery_size": len(labels)}:
        raise AssertionError(f"serve /enroll: {r}")
    r = json.loads(http_post(base, "/identify", pool_u8.tobytes(), {**u8, "X-Top-K": "5"}))
    top1 = [row[0] for row in r["labels"]]
    if top1 != labels:
        bad = [(i, t) for i, t in enumerate(top1) if t != labels[i]]
        raise AssertionError(f"serve /identify: rank 1 not the face's own label at {bad[:5]}")
    scores = np.asarray(r["scores"])
    snap = srv.gallery()
    dup = Gallery(torch.cat([snap.embeddings, snap.embeddings[7:8]]), snap.labels + ["dup07"])
    with EmbeddingHTTPServer(svc, gallery=dup) as srv2:
        r2 = json.loads(http_post(f"http://127.0.0.1:{srv2.port}", "/identify",
                                  pool_u8[7:8].tobytes(), {**u8, "X-Top-K": "2"}))
    if r2["labels"] != [["id07", "dup07"]] or r2["scores"][0][0] != r2["scores"][0][1]:
        raise AssertionError(f"serve: a duplicated face ranks {r2}, expected id07 then dup07")
    log("serve", f"gallery: /enroll {len(labels)} labels; /identify k=5 of the same faces: rank 1 "
        f"exact, self score min {scores[:, 0].min():.6f}, margin over rank 2 min "
        f"{(scores[:, 0] - scores[:, 1]).min():.6f}; a face enrolled twice (warm start) ranks "
        f"id07 then dup07 at equal scores {r2['scores'][0]}")
    return 2 * len(labels) + 1, 3


def serve_one(name, model, pool_u8, seconds, clients, card, gallery=False, latency=0):
    """One model behind EmbeddingService(max_batch=256) + the HTTP front on
    127.0.0.1:0: warmup, the direct N=1 latency, then the counted window
    (the load, /verify and the gallery, single-face latency), then the
    direct embed at the load's mean batch. -> the launch counts. bf16 and
    int8 rows are held to the direct embed by cosine (SERVE_BF16_MIN_COS):
    where a float layer rounds otherwise at another batch size, an int8
    level can move."""
    from ffrnet_torch.eval.lfw import pair_cosine
    from ffrnet_torch.models.quantize import quantized_sites
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
    from ffrnet_torch.serving import EmbeddingHTTPServer, EmbeddingService

    int8_sites = len(quantized_sites(model.encoder)) + len(quantized_sites(model.recnet))
    bf16 = model.dtype == torch.bfloat16 or int8_sites > 0  # held by cosine
    want = np.stack([t.float().cpu().numpy() for t in model.embed(pool_u8)])  # direct, N=64
    svc = EmbeddingService(model, max_batch=256)
    try:
        with EmbeddingHTTPServer(svc, ("127.0.0.1", 0)) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            t0 = time.perf_counter()
            svc.warmup()
            warm = time.perf_counter() - t0
            if latency:  # the direct call a served single face is compared with
                direct_1 = host_ms(lambda: model.embed(pool_u8[:1]), samples=latency)
            torch.cuda.synchronize()
            reset_launch_counts()
            faces, requests, wall, worst = serve_load(base, pool_u8, want, seconds, clients,
                                                      bf16, seed=100)
            st = svc.stats
            rate, mean = faces / wall, st.mean_batch
            padded = st.padded_faces / (st.faces + st.padded_faces)
            log("serve", f"{name}: {clients} clients x {wall:.2f} s of /embed (1-8 faces, float32 "
                f"and uint8 bodies): {rate:.1f} served faces/s, {requests / wall:.1f} "
                f"requests/s, {st.batches} batches, mean batch {mean:.2f}, padded fraction "
                f"{padded:.3f}; every response vs a direct embed: worst "
                f"{'1 - cosine' if bf16 else 'abs err'} {worst:.3e} (warmup of "
                f"{len(svc._buckets)} buckets {warm:.2f} s) | {card}")
            if gallery:
                s = np.frombuffer(http_post(base, "/verify", pool_u8.tobytes(),
                                            {"X-Input-Dtype": "uint8"}), "<f4")
                h = SERVE_POOL // 2
                e = check_close("/verify vs pair_cosine of direct embeds", torch.from_numpy(s.copy()),
                                pair_cosine(torch.from_numpy(want[1, :h]),
                                            torch.from_numpy(want[1, h:])), *VERIFY_TOL)
                log("serve", f"{name}: /verify {h} pairs vs pair_cosine of direct embeds: max_abs_err "
                    f"{e:.3e} (tol {VERIFY_TOL[0]})")
                f, r = serve_gallery(base, srv, svc, pool_u8)
                faces, requests = faces + SERVE_POOL + f, requests + 1 + r
            if latency:
                t = single_face_latency(base, pool_u8, latency)
                log("serve", f"{name}: single-face /embed at one client: p50 {np.median(t):.3f} ms, "
                    f"p90 {np.percentile(t, 90):.3f} ms ({latency} requests); direct embed N=1 "
                    f"(host uint8, synchronized) before the window: p50 {np.median(direct_1):.3f} "
                    f"ms, p90 {np.percentile(direct_1, 90):.3f} ms | {card}")
                faces, requests = faces + latency, requests + latency
            check_stats(name, base, svc, faces, requests)
            torch.cuda.synchronize()
            counts = launch_counts()
    finally:
        svc.close()
    check_serve_counts(name, counts, svc.stats.batches,
                       "self_similarity" if model.cfg.ss_impl == "kernel" else "channel_branch",
                       int8_sites)
    n = max(1, round(mean))
    batch = np.resize(pool_u8, (n,) + pool_u8.shape[1:])
    t = host_ms(lambda: model.embed(batch), samples=10)
    log("serve", f"{name}: direct embed at the load's mean batch N={n} (host uint8, synchronized): "
        f"median {np.median(t):.3f} ms, {n / np.median(t) * 1e3:.1f} faces/s, against "
        f"{rate:.1f} served faces/s | {card}")
    return counts


def phase_serve(models, card):
    """The serving path on the card: fused fp32 (load, /verify, gallery,
    latency), fused bf16 (load, latency), ss_kernel fp32 (a short load).
    -> the launch counts of the three counted windows, summed."""
    t0 = time.perf_counter()
    pool = torch.randint(0, 256, (SERVE_POOL, 112, 112, 3), generator=gen(60),
                         dtype=torch.uint8).numpy()
    runs = [("fused fp32", models["fused"], 5.0, SERVE_CLIENTS, dict(gallery=True, latency=100)),
            ("fused bf16", models["fused"].prepare(dtype=torch.bfloat16), 3.0, SERVE_CLIENTS,
             dict(latency=50)),
            ("ss_kernel fp32", models["ss_kernel"], 1.5, 8, {})]
    total = {k: 0 for k in KERNELS}
    for name, model, seconds, clients, kw in runs:
        for k, v in serve_one(name, model, pool, seconds, clients, card, **kw).items():
            total[k] += v
    log("serve", f"all serving checks passed in {time.perf_counter() - t0:.1f} s")
    return total


# ----------------------------------------------------------------- phase 11

# int8 vs the fp32 float model, held-out faces: the JAX package's bound
# (tests/test_quant.py); static vs dynamic on the calibration faces
# (tests/test_quant.py:128)
INT8_MIN_COS_FLOAT = 0.99
INT8_MIN_COS_STATIC = 0.999
# the same int8 model on the card and on the CPU: both products exact, but
# cuDNN's float layers (stem, BN, SE, PReLU) round otherwise than the CPU's,
# an int8 level moves now and then and the move spreads through later
# sites; measured on an H100: fp32 raw 0.99963, rectified 0.99999; bf16
# 1.000000 to six places (its 8-bit roundings hide most fp32 differences)
INT8_MIN_COS_CPU = {"fp32": 0.999, "bf16": 0.99}
INT8_HELD, INT8_DRIVER_BATCH, INT8_TIME_N = 64, 128, 256
INT8_ARMS = ("bf16 encoder dynamic", "bf16 encoder static", "bf16 all dynamic",
             "bf16 all static", "fp32 encoder dynamic", "fp32 encoder static")


def min_cos(a, b):
    return torch.nn.functional.cosine_similarity(a.float().cpu(), b.float().cpu(),
                                                 dim=1).min().item()


def int8_models(dev):
    """Float references (fp32, bf16; BNs folded) and the int8 arms of
    FFRNet.random(seed=0): prepare(fold_bn=True, dtype, quantize_int8=mode),
    dynamic, and calibrate_int8 on 8 uint8 faces (seed 110)."""
    from ffrnet_torch.api import FFRNet

    base = FFRNet.random(seed=0, device=dev)
    cal = torch.randint(0, 256, (8, 112, 112, 3), generator=gen(110), dtype=torch.uint8).numpy()
    models = {"fp32 float": base.prepare(fold_bn=True),
              "bf16 float": base.prepare(fold_bn=True, dtype=torch.bfloat16)}
    t0 = time.perf_counter()
    for name in INT8_ARMS:
        dname, mode, scales = name.split()
        dt = torch.bfloat16 if dname == "bf16" else None
        if scales == "dynamic":
            models[name] = base.prepare(fold_bn=True, dtype=dt, quantize_int8=mode)
        else:
            models[name] = models[f"{dname} {mode} dynamic"].calibrate_int8([cal])
    log("int8", f"models: IR-SE50 + RecNet (C=512), seed 0, BN folded; arms {INT8_ARMS}; "
        f"calibrate_int8 on 8 faces (seed 110); prepared in {time.perf_counter() - t0:.1f} s")
    return models, cal


def int8_checks(models, cal, dev):
    """Sites, accuracy against float, static against dynamic, the card
    against the CPU, and the exact launches of one embed per arm. -> the
    launch counts of the counted embeds, summed."""
    from ffrnet_torch.api import FFRNet
    from ffrnet_torch.models.quantize import quantized_sites
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts

    held = torch.randint(0, 256, (INT8_HELD, 112, 112, 3), generator=gen(111),
                         dtype=torch.uint8).to(dev)
    ref = models["fp32 float"].embed(held)
    total = {k: 0 for k in KERNELS}
    for name in INT8_ARMS:
        m = models[name]
        sites = (len(quantized_sites(m.encoder)), len(quantized_sites(m.recnet)))
        want_sites = (INT8_ENCODER_SITES, INT8_RECNET_SITES if " all " in name else 0)
        static = [s.x_scale is not None for _, s in quantized_sites(m.encoder)]
        if sites != want_sites or set(static) != {name.endswith("static")}:
            raise AssertionError(f"int8 {name}: sites {sites}, static scales {set(static)}")
        torch.cuda.synchronize()
        reset_launch_counts()
        out = m.embed(held)
        torch.cuda.synchronize()
        counts = launch_counts()
        expected = {k: 0 for k in KERNELS}
        expected.update(se_gating=24, channel_branch=1, int8_conv=sum(sites))
        if counts != expected:
            raise AssertionError(f"int8 {name}: one embed launched {counts}, expected {expected}")
        for k in total:
            total[k] += counts[k]
        for t in out:
            if tuple(t.shape) != (INT8_HELD, 512) or not torch.isfinite(t).all():
                raise AssertionError(f"int8 {name}: embedding {tuple(t.shape)} not finite")
        cos = [min_cos(a, b) for a, b in zip(out, ref)]
        if min(cos) < INT8_MIN_COS_FLOAT:
            raise AssertionError(f"int8 {name} vs fp32 float: min cosine {cos} below "
                                 f"{INT8_MIN_COS_FLOAT}")
        log("int8", f"{name}: {sites[0]} encoder + {sites[1]} RecNet int8 sites; one embed of "
            f"{INT8_HELD} held-out faces launched {counts['int8_conv']} int8_conv, 24 se_gating, 1 "
            f"channel_branch; vs the fp32 float model min cosine raw {cos[0]:.5f} rect "
            f"{cos[1]:.5f} (bound {INT8_MIN_COS_FLOAT})")
    for key in ("bf16 encoder", "bf16 all", "fp32 encoder"):
        cos = [min_cos(a, b) for a, b in zip(models[f"{key} static"].embed(cal),
                                             models[f"{key} dynamic"].embed(cal))]
        if min(cos) < INT8_MIN_COS_STATIC:
            raise AssertionError(f"int8 {key}: static vs dynamic min cosine {cos} below "
                                 f"{INT8_MIN_COS_STATIC}")
        log("int8", f"{key}: static vs dynamic on the 8 calibration faces: min cosine raw "
            f"{cos[0]:.6f} rect {cos[1]:.6f} (bound {INT8_MIN_COS_STATIC})")
    for key in ("fp32 encoder static", "bf16 all static"):
        m = models[key]
        cpu = FFRNet(m.encoder, m.recnet, m.cfg, "cpu").prepare()
        cos = [min_cos(a, b) for a, b in zip(m.embed(held[:4]), cpu.embed(held[:4].cpu()))]
        bound = INT8_MIN_COS_CPU[key.split()[0]]
        if min(cos) < bound:
            raise AssertionError(f"int8 {key}: card vs CPU min cosine {cos} below {bound}")
        log("int8", f"{key}: card vs CPU (the twin), 4 faces: min cosine raw {cos[0]:.6f} rect "
            f"{cos[1]:.6f} (bound {bound})")
    return total


def int8_driver(dev, card):
    """python -m ffrnet_torch.train --int8_encoder 1 on phase 9's JPEG tree:
    fp32 raw-image steps (batch 128, 2 steps, the eval at step 2 on the
    float encoder), then a bf16 --cache_features 1 run (the cache built by
    the int8 encoder, 2 RecNet-only steps), each call's launches checked
    exactly. -> the launch counts of the steps and the build, summed."""
    import tempfile

    import ffrnet_torch.train as T
    from ffrnet_torch.config import parse_args
    from ffrnet_torch.data.datasets import CasiaPairs
    from ffrnet_torch.training.feature_cache import cache_fingerprint

    total = {k: 0 for k in KERNELS}
    probe = DriverProbe()
    try:
        with tempfile.TemporaryDirectory(prefix="ffrnet_int8_") as root:
            tree = os.path.join(root, "faces")
            driver_tree(tree)
            short = ("--int8_encoder", "1", "--batch_size", str(INT8_DRIVER_BATCH),
                     "--total_epochs", "1", "--save_freq", "1000")
            argv = driver_argv(tree, os.path.join(root, "raw"), *short, "--eval_freq", "2")
            t = time.perf_counter()
            T.main(argv)
            raw_s = time.perf_counter() - t
            if len(probe.steps) != 2 or len(probe.evals) != 3 * -(-DRIVER_PAIRS // INT8_DRIVER_BATCH):
                raise AssertionError(f"int8 driver: {len(probe.steps)} steps, "
                                     f"{len(probe.evals)} eval batches")
            check_driver_counts("int8 raw-image train_step", probe.steps,
                                {"se_gating": 24, "int8_conv": INT8_ENCODER_SITES})
            check_driver_counts("int8 run's eval batch (float encoder)", probe.evals,
                                DRIVER_COUNTS["fused", "eval"])
            for rec in probe.steps:
                for k in total:
                    total[k] += rec[1][k]
            step_ms = [m for m, _ in probe.steps]
            probe.reset()
            argv_c = driver_argv(tree, os.path.join(root, "cached"), *short, "--eval_freq", "0",
                                 "--compute_dtype", "bf16", "--cache_features", "1")
            opts_c = parse_args(argv_c, make_dirs=False)
            T.main(argv_c)
            (build_ms, _), = probe.builds
            batches = -(-DRIVER_IDS * DRIVER_PER_ID // INT8_DRIVER_BATCH)
            # the build's encoder is made inside it: its calibration pass (8
            # images, float sites) launches one forward's 24 SE gates
            check_driver_counts("int8 bf16 feature-cache build", probe.builds,
                                {"se_gating": 24 * (2 * batches + 1),
                                 "int8_conv": 2 * INT8_ENCODER_SITES * batches})
            check_driver_counts("cached step", probe.steps, {})
            for k in total:
                total[k] += probe.builds[0][1][k]
            with open(os.path.join(opts_c.ckpt_dir, "feature_cache", "meta.json")) as f:
                fp = json.load(f)["fingerprint"]
            ds = CasiaPairs(opts_c.train_data, opts_c.train_img_list, use_native=False)
            enc = T.load_encoder(opts_c, dev)
            if fp != cache_fingerprint(ds, enc, "int8-static-v1") or fp == cache_fingerprint(ds, enc):
                raise AssertionError("int8 driver: the cache's fingerprint is not the int8 build's")
    finally:
        probe.close()
    log("int8", f"--int8_encoder 1: 2 fp32 raw-image steps ({', '.join(f'{m:.1f}' for m in step_ms)} "
        f"ms, calibration and eval included in the run's {raw_s:.1f} s), eval on the float encoder; "
        f"bf16 cache build by the int8 encoder in {build_ms / 1e3:.2f} s, fingerprint "
        f"{fp[:12]}... differs from the float build's | {card}")
    return total


def int8_bound(calls):
    """(bound_ms, bound_by) of int8_conv calls (xq, wp, deq, bias, stride,
    padding, out_dtype): the int8 input, the int8 weights and the output
    moved once at the HBM rate, or 2 N Ho Wo Cout KH KW C operations at
    the int8 tensor-core rate, whichever is larger for the whole set."""
    nbytes = ops = 0
    for xq, wp, deq, bias, stride, pad, out_dtype in calls:
        n, h, w, cp = xq.shape
        _, kh, kw, _ = wp.shape
        cout = deq.shape[0]
        ho, wo = (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1
        ops += 2 * n * ho * wo * cout * kh * kw * cp
        nbytes += (xq.numel() + cout * kh * kw * cp + n * cout * ho * wo * out_dtype.itemsize
                   + 4 * cout * (1 + (bias is not None)))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def int8_times(models, dev, card):
    """Embed faces/s at N=256 (host uint8 in, both embeddings out, median of
    10 batches) for every arm beside the float models, N=1 latency, and
    int8_conv's device time over one encoder forward's 52 calls (recorded
    from an fp32 and a bf16 embed at N=256) beside its bound, its twin and
    cuDNN's bf16 convolutions of the same 51 shapes plus a bf16 F.linear
    of the Linear's (a yardstick: another function). -> (ms, plain ms,
    (bound_ms, bound_by)) of the fp32 forward's calls."""
    import ffrnet_torch.ops.quant as Q
    from ffrnet_torch.ops.kernels.int8_conv import int8_conv, int8_conv_plain

    n = INT8_TIME_N
    faces = torch.randint(0, 256, (n, 112, 112, 3), generator=gen(40), dtype=torch.uint8).numpy()
    for name in ("fp32 float", "bf16 float") + INT8_ARMS:
        t = host_ms(lambda: models[name].embed(faces), samples=10)
        log("times", f"int8 phase embed {name} N={n}: median {np.median(t):.3f} ms/batch (max "
            f"{t.max():.3f}, 10 samples), {n / np.median(t) * 1e3:.1f} faces/s | {card}")
    for name in ("fp32 float", "fp32 encoder static", "bf16 float", "bf16 encoder static",
                 "bf16 all static"):
        t1 = host_ms(lambda: models[name].embed(faces[:1]), samples=50, warmup=5)
        log("times", f"int8 phase embed {name} N=1 latency: p50 {np.median(t1):.3f} ms, p90 "
            f"{np.percentile(t1, 90):.3f} ms (50 samples) | {card}")
    recorded = {}
    for dname in ("fp32", "bf16"):
        calls = []

        def record(xq, wp, deq, bias=None, *, stride=1, padding=0, out_dtype=torch.float32):
            calls.append((xq, wp, deq, bias, stride, padding, out_dtype))
            return int8_conv(xq, wp, deq, bias, stride=stride, padding=padding,
                             out_dtype=out_dtype)

        real, Q.int8_conv = Q.int8_conv, record
        try:
            models[f"{dname} encoder static"].embed(faces)
        finally:
            Q.int8_conv = real
        if len(calls) != INT8_ENCODER_SITES:
            raise AssertionError(f"int8 {dname}: {len(calls)} int8_conv calls per encoder forward")
        recorded[dname] = calls

    def run(fn, calls):
        def go():
            for xq, wp, deq, bias, stride, pad, dt in calls:
                fn(xq, wp, deq, bias, stride=stride, padding=pad, out_dtype=dt)
        return go

    out = {}
    for dname, calls in recorded.items():
        kern, plain = run(int8_conv, calls), run(int8_conv_plain, calls)
        p1, k1, k2, p2 = (cuda_ms(plain, iters=2, warmup=1), cuda_ms(kern, iters=10),
                          cuda_ms(kern, iters=10), cuda_ms(plain, iters=2, warmup=1))
        bound = int8_bound(calls)
        per_call = sum(int8_bound([c])[0] for c in calls)
        out[dname] = (min(k1, k2), min(p1, p2), bound)
        log("times", f"int8_conv {dname} out, one encoder forward's {len(calls)} calls at N={n}: "
            f"kernel {k1:.4f}/{k2:.4f} ms, plain (float64 twin) {p1:.4f}/{p2:.4f} ms, bound "
            f"{bound[0]:.4f} ms ({bound[1]}, the set as one; {100 * bound[0] / min(k1, k2):.0f}%), "
            f"sum of the calls' own bounds {per_call:.4f} ms "
            f"({100 * per_call / min(k1, k2):.0f}%) | {card}")
    # by shape, fp32 out: the kernel's share of each site's bound, its plan,
    # and torch._int_mm (cuBLASLt) on the same integers as a yardstick: the
    # im2col matrix built outside the timed window, no epilogue
    shapes = {}
    for c in recorded["fp32"]:
        key = (tuple(c[0].shape), tuple(c[1].shape), c[4], c[5])
        shapes.setdefault(key, []).append(c)
    for (xs, ws, stride, pad), calls in shapes.items():
        t = cuda_ms(run(int8_conv, calls[:1]), iters=10)
        dev_t = graph_ms(run(int8_conv, calls[:1]))  # without the wrapper's host time
        b = int8_bound(calls[:1])
        xq, wp, deq = calls[0][:3]
        plan = int8_plan_of((xq, wp), stride, pad, torch.float32)
        try:
            a = torch.nn.functional.unfold(xq.permute(0, 3, 1, 2).half(), ws[1:3], padding=pad,
                                           stride=stride)  # (N, Cp KH KW, L), exact
            a = a.transpose(1, 2).reshape(-1, a.shape[1]).to(torch.int8).contiguous()
            wmat = wp[:deq.shape[0]].permute(0, 3, 1, 2).reshape(deq.shape[0], -1)
            wt = wmat.contiguous().t()  # (K, Cout), column-major
            mm = f"{cuda_ms(lambda: torch._int_mm(a, wt), iters=10):.4f} ms"
            del a, wmat, wt
        except RuntimeError as e:
            mm = f"n/a ({str(e).splitlines()[0][:80]})"
        log("times", f"int8_conv x{xs} w{ws} stride {stride} pad {pad} (x{len(calls)} per "
            f"forward): {t:.4f} ms, bound {b[0]:.4f} ms ({b[1]}; {100 * b[0] / t:.0f}%); device "
            f"time (graph) {dev_t:.4f} ms ({100 * b[0] / dev_t:.0f}%); {plan_str(plan)}; "
            f"torch._int_mm of the im2col product {mm}")
        torch.cuda.empty_cache()
    # yardstick: cuDNN's bf16 convolutions of the 51 conv shapes, NCHW, and
    # a bf16 F.linear for the Linear (a float product, not the int8 one)
    g = gen(112)
    fns = []
    for xq, wp, deq, _, stride, pad, _ in recorded["fp32"]:
        nn_, h, w, cp = xq.shape
        cout, kh, kw = deq.shape[0], wp.shape[1], wp.shape[2]
        if h == 1:  # the Linear
            x = torch.randn(nn_, cp, generator=g).to(dev, torch.bfloat16)
            wt = torch.randn(cout, cp, generator=g).to(dev, torch.bfloat16)
            fns.append(lambda x=x, wt=wt: torch.nn.functional.linear(x, wt))
        else:
            x = torch.randn(nn_, cp, h, w, generator=g).to(dev, torch.bfloat16)
            wt = torch.randn(cout, cp, kh, kw, generator=g).to(dev, torch.bfloat16)
            fns.append(lambda x=x, wt=wt, s=stride, p=pad: torch.nn.functional.conv2d(
                x, wt, stride=s, padding=p))

    def yard():
        for f in fns:
            f()

    y = min(cuda_ms(yard, iters=10), cuda_ms(yard, iters=10))
    log("times", f"yardstick cuDNN bf16 F.conv2d of the same 51 conv shapes + bf16 F.linear of the "
        f"Linear's (NCHW, float products, not the same function): {y:.4f} ms | {card}")
    del recorded, fns
    torch.cuda.empty_cache()
    return out["fp32"]


def phase_int8(dev, card):
    """-> (launch counts of phase 11's counted runs, (ms, plain ms, bound))."""
    t0 = time.perf_counter()
    models, cal = int8_models(dev)
    total = int8_checks(models, cal, dev)
    pool = torch.randint(0, 256, (SERVE_POOL, 112, 112, 3), generator=gen(60),
                         dtype=torch.uint8).numpy()
    for k, v in serve_one("int8_static fp32 (encoder)", models["fp32 encoder static"], pool,
                          2.0, 8, card).items():
        total[k] += v
    for k, v in int8_driver(dev, card).items():
        total[k] += v
    times = int8_times(models, dev, card)
    del models
    torch.cuda.empty_cache()
    log("int8", f"all int8 checks passed in {time.perf_counter() - t0:.1f} s")
    return total, times


# ----------------------------------------------------------------- phase 12

# each exported program at these batches against embed of the same model in
# the same call; fp32: the JAX export test's bound (tests/test_export.py:
# 36-39); bf16 and int8: phase 10's bf16 bound, cosine per row
EXPORT_NS = (1, 3, 256)
EXPORT_TOL = (1e-4, 1e-4)
EXPORT_MIN_COS = SERVE_BF16_MIN_COS


def export_models(models, dev):
    """The four exported configurations -> {name: (model, the operator nodes
    its graph must hold, which are also its launches per call)}: fused fp32 and bf16,
    ss_kernel fp32, and the BN-folded bf16 int8 "all" model calibrated on
    phase 11's 8 faces."""
    from ffrnet_torch.api import FFRNet

    cal = torch.randint(0, 256, (8, 112, 112, 3), generator=gen(110), dtype=torch.uint8).numpy()
    int8_all = FFRNet.random(seed=0, device=dev).prepare(
        fold_bn=True, dtype=torch.bfloat16, quantize_int8="all").calibrate_int8([cal])
    fused = {"se_gating": 24, "channel_branch": 1}
    return {"fused fp32": (models["fused"], fused),
            "fused bf16": (models["fused"].prepare(dtype=torch.bfloat16), fused),
            "ss_kernel fp32": (models["ss_kernel"], {"se_gating": 24, "self_similarity": 1}),
            "int8 all bf16 static": (int8_all, dict(fused, int8_conv=INT8_ENCODER_SITES
                                                    + INT8_RECNET_SITES))}


def export_round_trip(name, model, want_ops, root):
    """export_embed with a symbolic batch, torch.export.save to `root`,
    torch.export.load; the operator nodes of the loaded graph checked. ->
    the loaded program's module."""
    from ffrnet_torch.tools.export_model import export_embed, input_shape

    t0 = time.perf_counter()
    program = export_embed(model)
    t1 = time.perf_counter()
    path = os.path.join(root, name.replace(" ", "_") + ".pt2")
    torch.export.save(program, path)
    t2 = time.perf_counter()
    loaded = torch.export.load(path)
    t3 = time.perf_counter()
    nodes, calls, checks = {}, 0, 0
    for node in loaded.graph.nodes:
        target = str(node.target)
        if node.op != "call_function":
            continue
        calls += 1
        if target.startswith("ffrnet."):
            op = target.split(".")[1]
            nodes[op] = nodes.get(op, 0) + 1
        checks += target == "aten._assert_tensor_metadata.default"
    if nodes != want_ops or input_shape(loaded) != ["b", 112, 112, 3]:
        raise AssertionError(f"export {name}: operator nodes {nodes}, expected {want_ops}; "
                             f"input {input_shape(loaded)}")
    # the checks run on the host at every call (torch.export records one per
    # .to(dtype) of the traced code) and launch nothing
    log("export", f"{name}: exported in {t1 - t0:.1f} s, saved ({os.path.getsize(path) / 1e6:.1f} "
        f"MB) in {t2 - t1:.1f} s, loaded in {t3 - t2:.1f} s; input {input_shape(loaded)}; "
        f"operator nodes {nodes} of {calls} call nodes, {checks} of them "
        f"aten._assert_tensor_metadata")
    return loaded.module()


def export_check(name, model, run, want_ops, faces):
    """The loaded program at each of EXPORT_NS against embed of the same
    faces, and the launches of each of its calls. -> the launch counts of
    those calls, summed."""
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts

    expected = {k: want_ops.get(k, 0) for k in KERNELS}
    total = {k: 0 for k in KERNELS}
    for n in EXPORT_NS:
        x = model._unit(faces[:n])
        want = model.embed(x)
        torch.cuda.synchronize()
        reset_launch_counts()
        with torch.inference_mode():
            got = run(x.to(model.dtype))
        torch.cuda.synchronize()
        counts = launch_counts()
        if counts != expected:
            raise AssertionError(f"export {name} N={n}: one call launched {counts}, expected "
                                 f"{expected}")
        for k in total:
            total[k] += counts[k]
        for t in got:
            if tuple(t.shape) != (n, 512) or t.dtype != model.dtype or not torch.isfinite(t).all():
                raise AssertionError(f"export {name} N={n}: output {tuple(t.shape)} {t.dtype}")
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        if model.dtype == torch.float32:
            err = max(check_close(f"export {name} N={n}", a, b, *EXPORT_TOL)
                      for a, b in zip(got, want))
            what = f"max_abs_err {err:.3e} (tol atol={EXPORT_TOL[0]} rtol={EXPORT_TOL[1]})"
        else:
            cos = min(min_cos(a, b) for a, b in zip(got, want))
            if not cos >= EXPORT_MIN_COS:
                raise AssertionError(f"export {name} N={n}: min cosine {cos:.6f} below "
                                     f"{EXPORT_MIN_COS}")
            what = f"min cosine {cos:.6f} (bound {EXPORT_MIN_COS})"
        log("export", f"{name} N={n}: loaded program vs embed {what}, bit-equal {equal}; one "
            f"call launched {({k: v for k, v in counts.items() if v})}")
    return total


def phase_export(models, dev, card):
    """Export, save, load and run each configuration of `export_models`;
    the loaded program's N=256 faces/s beside embed's on the same device
    faces (a record, not a claim). -> the launch counts of the checked
    calls, summed."""
    import tempfile

    t0 = time.perf_counter()
    faces = torch.randint(0, 256, (max(EXPORT_NS), 112, 112, 3), generator=gen(120),
                          dtype=torch.uint8).to(dev)
    total = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory(prefix="ffrnet_export_") as root:
        for name, (model, want_ops) in export_models(models, dev).items():
            run = export_round_trip(name, model, want_ops, root)
            for k, v in export_check(name, model, run, want_ops, faces).items():
                total[k] += v
            x = model._unit(faces).to(model.dtype)

            def program():
                with torch.inference_mode():
                    run(x)

            t_p, t_e = host_ms(program, samples=10), host_ms(lambda: model.embed(x), samples=10)
            log("times", f"export {name} N={len(x)} device faces in: loaded program median "
                f"{np.median(t_p):.3f} ms, {len(x) / np.median(t_p) * 1e3:.1f} faces/s; embed "
                f"median {np.median(t_e):.3f} ms, {len(x) / np.median(t_e) * 1e3:.1f} faces/s "
                f"(10 samples each) | {card}")
    torch.cuda.empty_cache()
    log("export", f"all export checks passed in {time.perf_counter() - t0:.1f} s")
    return total


# ----------------------------------------------------------------- phase 13

DP_WORLD, DP_BATCH, DP_STEPS, DP_EVAL_BATCH = 2, 64, 2, 100
# SGD, momentum 0.9, lr 1e-3: the update is linear in the gradient, so
# two summation orders stay within the train parity bounds (Adam's
# m/sqrt(v) would move a weight whose gradient is rounding noise by up to
# 2 lr either way)
DP_OPT = dict(optimizer="sgd", lr=1e-3, momentum=0.9)
DP_KINDS = (("fused", "train_step", {"se_gating": 24}),
            ("ss_kernel", "train_step_from_features", {"self_similarity": 7}))
SHARD_NS = (1, 11, 256)


def dp_inputs(dev):
    """Two global batches of 64 uint8 faces (seed 130) and their frozen
    features (fp32, NCHW; the encoder of seed 0 on the card)."""
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.training.trainer import encode_frozen

    enc = build_backbone(generator=gen(0)).to(dev).eval()
    batches = [image_batch(DP_BATCH, 130 + i) for i in range(DP_STEPS)]
    feats = [{k: v.cpu() for k, v in encode_frozen(enc, b).items()} for b in batches]
    return enc, batches, feats


def dp_state_of(state):
    return {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}


def dp_checksum(state):
    import hashlib

    h = hashlib.sha256()
    for k, v in state.model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dp_run(kind, step, state, batches, rank, world, group):
    """DP_STEPS updates of one rank on its shard -> per step (host ms,
    launches, metrics averaged over the group, checksum), the final state."""
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
    from ffrnet_torch.parallel.collectives import average_tensor

    out = []
    for b in batches:
        n = len(b["label"]) // world
        local = {k: v[rank * n:(rank + 1) * n] for k, v in b.items()}
        torch.cuda.synchronize()
        reset_launch_counts()
        t = time.perf_counter()
        state, m = step(state, local)
        torch.cuda.synchronize()
        ms, counts = (time.perf_counter() - t) * 1e3, launch_counts()
        metrics = {k: float(v) if k == "LR" or group is None
                   else float(average_tensor(v.float(), group)) for k, v in m.items()}
        out.append((ms, counts, metrics, dp_checksum(state)))
    return out, dp_state_of(state)


def dp_rank(rank, world, port, path):
    """One rank of phase 13 on cuda:0 under a gloo group: the distributed
    train_step (fused) and train_step_from_features (ss_kernel), then
    evaluate_pairs_multiprocess over its slice of the pairs. Writes
    path.<rank>. A rank that finds no card raises."""
    import torch.distributed as dist

    from ffrnet_torch import parallel
    from ffrnet_torch.data.datasets import LfwPairs
    from ffrnet_torch.data.pipeline import BatchLoader, SliceDataset
    from ffrnet_torch.eval.runner import (evaluate_pairs_multiprocess, make_pair_score_fn,
                                          process_pair_slice)
    from ffrnet_torch.models.recnet import RecNetConfig, build_recnet
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
    from ffrnet_torch.training.trainer import (create_train_state, make_distributed_feature_step,
                                               make_distributed_step)

    if not torch.cuda.is_available():
        raise RuntimeError(f"phase 13 rank {rank}: no card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    inp = torch.load(path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = parallel.make_mesh()
        group = parallel.data_group(mesh)
        from ffrnet_torch.models.irse import build_backbone

        enc = build_backbone(generator=gen(0)).to(dev).eval()
        res = {}
        for name, what, _ in DP_KINDS:
            cfg = train_cfg(name, **DP_OPT)
            state = create_train_state(cfg, seed=1, device=dev)
            if what == "train_step":
                bound, (enc, state) = make_distributed_step(mesh, cfg, enc, state)
                step = functools.partial(bound, enc)
                batches = inp["batches"]
            else:
                step, state = make_distributed_feature_step(mesh, cfg, state)
                batches = inp["feats"]
            res[name] = dp_run(name, step, state, batches, rank, world, group)
        rec = build_recnet(RecNetConfig(), generator=gen(1)).to(dev).eval()
        ds = LfwPairs(inp["tree"], os.path.join(inp["tree"], "pairs.txt"), test_ocl_num=1,
                      flip_prob=0.0)
        local = SliceDataset(ds, process_pair_slice(len(ds), rank, world))
        loader = BatchLoader(local, DP_EVAL_BATCH, shuffle=False, drop_last=False, num_threads=4,
                             device=dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        folds = evaluate_pairs_multiprocess(make_pair_score_fn(enc, rec), loader.epoch(0),
                                            n_pairs=len(ds), return_scores=True)
        torch.cuda.synchronize()
        res["eval"] = (folds, launch_counts(), -(-len(local) // DP_EVAL_BATCH))
        torch.save(res, f"{path}.{rank}")
    finally:
        dist.destroy_process_group()


def dp_free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_reference(enc, batches, feats, dev):
    """The single-process steps on the same global batches."""
    from ffrnet_torch.training.trainer import (create_train_state, train_step,
                                               train_step_from_features)

    out = {}
    for name, what, _ in DP_KINDS:
        cfg = train_cfg(name, **DP_OPT)
        state = create_train_state(cfg, seed=1, device=dev)
        if what == "train_step":
            step = functools.partial(train_step, enc, cfg=cfg)
        else:
            step = functools.partial(train_step_from_features, cfg=cfg)
        out[name] = dp_run(name, step, state, batches if what == "train_step" else feats, 0, 1,
                           None)
    return out


def dp_steps_and_eval(tree, dev, card):
    """(a) and (b): two ranks against one process. -> the ranks' launches."""
    import torch.multiprocessing as mp

    from ffrnet_torch.data.datasets import LfwPairs
    from ffrnet_torch.data.pipeline import BatchLoader
    from ffrnet_torch.eval.runner import evaluate_pairs, make_pair_score_fn
    from ffrnet_torch.models.recnet import RecNetConfig, build_recnet

    enc, batches, feats = dp_inputs(dev)
    path = os.path.join(tree, "dp_inputs.pt")
    torch.save({"batches": [{k: v.cpu() for k, v in b.items()} for b in batches],
                "feats": feats, "tree": tree}, path)
    t0 = time.perf_counter()
    mp.start_processes(dp_rank, args=(DP_WORLD, dp_free_port(), path), nprocs=DP_WORLD,
                       join=True, start_method="spawn")
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(f"{path}.{r}", weights_only=False) for r in range(DP_WORLD)]
    single = dp_reference(enc, batches, [{k: v.to(dev) for k, v in f.items()} for f in feats],
                          dev)
    total = {k: 0 for k in KERNELS}
    for name, what, want in DP_KINDS:
        expected = {k: want.get(k, 0) for k in KERNELS}
        (steps0, sd0), (steps1, sd1) = (r[name] for r in ranks)
        ref_steps, ref_sd = single[name]
        for r, steps in enumerate((steps0, steps1)):
            for i, (_, counts, _, _) in enumerate(steps):
                if counts != expected:
                    raise AssertionError(f"data parallel {name} rank {r} step {i}: launches "
                                         f"{counts}, expected {expected}")
                for k in total:
                    total[k] += counts[k]
        sums = [[s[3] for s in steps] for steps in (steps0, steps1)]
        if sums[0] != sums[1] or any(not torch.equal(sd0[k], sd1[k]) for k in sd0):
            raise AssertionError(f"data parallel {name}: the ranks' states differ ({sums})")
        for (_, _, m, _), (_, _, m_ref, _) in zip(steps0, ref_steps):
            for k in m_ref:
                if abs(m[k] - m_ref[k]) > TRAIN_LOSS_RTOL * abs(m_ref[k]) + 1e-6:
                    raise AssertionError(f"data parallel {name}: {k} {m[k]} vs one process "
                                         f"{m_ref[k]}")
        params = [k for k in ref_sd if "running" not in k and ref_sd[k].is_floating_point()]
        err = max(check_close(f"data parallel {name} {k} vs one process", sd0[k], ref_sd[k],
                              TRAIN_PARAM_ATOL, 0.0) for k in params)
        stats = max((sd0[k] - ref_sd[k]).abs().max().item() for k in ref_sd if "running" in k)
        log("data_parallel", f"{name} {what}: {DP_WORLD} ranks x {DP_BATCH // DP_WORLD} faces "
            f"(gloo on cuda:0) vs one process x {DP_BATCH}, {DP_STEPS} SGD updates: parameters "
            f"max_abs_err {err:.3e} (tol {TRAIN_PARAM_ATOL}), running stats {stats:.3e} "
            f"(reported), losses within {TRAIN_LOSS_RTOL} rel (TotalLoss "
            f"{steps0[0][2]['TotalLoss']:.4f}, {steps0[-1][2]['TotalLoss']:.4f}); rank checksums "
            f"equal at every step; launches per rank per step "
            f"{ {k: v for k, v in expected.items() if v} }")
        log("times", f"data parallel {name} {what}: 2-rank step ms (rank 0: "
            f"{', '.join(f'{s[0]:.1f}' for s in steps0)}; rank 1: "
            f"{', '.join(f'{s[0]:.1f}' for s in steps1)}; both ranks on one card) beside the "
            f"one-process step ms at N={DP_BATCH} ({', '.join(f'{s[0]:.1f}' for s in ref_steps)}; "
            f"the first step of each includes its warm-up) | {card}")

    rec = build_recnet(RecNetConfig(), generator=gen(1)).to(dev).eval()
    ds = LfwPairs(tree, os.path.join(tree, "pairs.txt"), test_ocl_num=1, flip_prob=0.0)
    loader = BatchLoader(ds, DP_EVAL_BATCH, shuffle=False, drop_last=False, num_threads=8,
                         device=dev)
    want = evaluate_pairs(make_pair_score_fn(enc, rec), loader.epoch(0), return_scores=True)
    for r, res in enumerate(ranks):
        folds, counts, n_batches = res["eval"]
        for got, ref in zip(folds[:2], want[:2]):
            for a, b in zip(got, ref):
                if not torch.equal(a, b):
                    raise AssertionError(f"data parallel eval rank {r}: fold results {got} vs "
                                         f"one process {ref}")
        expected = {k: DRIVER_COUNTS["fused", "eval"].get(k, 0) * n_batches for k in KERNELS}
        if counts != expected:
            raise AssertionError(f"data parallel eval rank {r}: launches {counts}, expected "
                                 f"{expected}")
        for k in total:
            total[k] += counts[k]
    same = all(np.array_equal(a, b) for a, b in zip(ranks[0]["eval"][0][2:], want[2:]))
    log("data_parallel", f"evaluate_pairs_multiprocess over {len(ds)} pairs (ocl 1, batches of "
        f"{DP_EVAL_BATCH}, {DP_WORLD} ranks of {len(ds) // DP_WORLD}): fold results bit-equal "
        f"to evaluate_pairs on every rank (mean accuracy rectified "
        f"{float(want[0].mean_accuracy):.4f}, raw {float(want[1].mean_accuracy):.4f}); gathered "
        f"scores bit-equal to the one-process scores: {same}; ranks spawned and joined in "
        f"{spawn_s:.1f} s")
    return total


def dp_driver(tree, root, card):
    """(c) python -m ffrnet_torch.train's main under FFRNET_DISTRIBUTED=1,
    RANK=0, WORLD_SIZE=1 (NCCL) against the same run without it."""
    from ffrnet_torch import parallel
    from ffrnet_torch.checkpoint.store import load_checkpoint
    from ffrnet_torch.config import parse_args
    import ffrnet_torch.train as T

    extra = ("--total_epochs", "1", "--optimizer", "sgd", "--lr", "1e-3", "--momentum", "0.9")
    env = {"FFRNET_DISTRIBUTED": "1", "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1"}
    joined = []
    real_init = parallel.maybe_init_distributed

    def init(device):
        import torch.distributed as dist

        dev = real_init(device)
        if dev is not None:
            joined.append((dev, dist.get_backend(), dist.get_world_size(),
                           parallel.host_group() is not None))
        return dev

    probe = DriverProbe()
    parallel.maybe_init_distributed = init
    total = {k: 0 for k in KERNELS}
    try:
        ckpts = {}
        for mode in ("one process", "distributed"):
            probe.reset()
            argv = driver_argv(tree, os.path.join(root, mode.replace(" ", "_")), *extra)
            if mode == "distributed":
                os.environ.update(env, MASTER_PORT=str(dp_free_port()))
            try:
                T.main(argv)
            finally:
                for k in env:
                    os.environ.pop(k, None)
            if joined != ([(torch.device("cuda", 0), "nccl", 1, True)] if mode == "distributed"
                          else []):
                raise AssertionError(f"driver {mode}: process groups joined {joined}")
            check_driver_counts(f"{mode} fp32 fused train_step", probe.steps,
                                DRIVER_COUNTS["fused", "train_step"])
            check_driver_counts(f"{mode} fp32 fused eval batch", probe.evals,
                                DRIVER_COUNTS["fused", "eval"])
            if len(probe.steps) != 4:
                raise AssertionError(f"driver {mode}: {len(probe.steps)} steps, expected 4")
            if mode == "distributed":
                for _, c in probe.steps + probe.evals:
                    for k in total:
                        total[k] += c[k]
            opts = parse_args(argv, make_dirs=False)
            ckpts[mode] = (sorted(n for n in os.listdir(opts.ckpt_dir) if n.endswith(".pth.gzip")),
                           load_checkpoint(opts.ckpt_dir, "latest"))
        (names_1, (sd_1, _, meta_1)), (names_d, (sd_d, _, meta_d)) = ckpts.values()
        if names_d != names_1 or meta_d != meta_1:
            raise AssertionError(f"driver distributed: checkpoints {names_d} {meta_d} vs "
                                 f"{names_1} {meta_1}")
        # the parameters within 1e-5; the running stats reported: cuDNN's
        # backward is not deterministic, and ChannelFlipMerge.0's BN input
        # (a large offset common to its channels) carries that into its
        # running mean at a few 1e-5 after 4 updates, between two runs of
        # the same code
        err = max(check_close(f"driver distributed {k} vs one process", sd_d[k], sd_1[k],
                              TRAIN_PARAM_ATOL, 0.0)
                  for k in sd_1 if sd_1[k].is_floating_point() and "running" not in k)
        stats = max((sd_d[k] - sd_1[k]).abs().max().item() for k in sd_1 if "running" in k)
        os.environ.update(env, MASTER_PORT=str(dp_free_port()))
        try:
            T.main(driver_argv(tree, os.path.join(root, "mesh2"), *extra, "--mesh_data", "2"))
            raise AssertionError("driver --mesh_data 2 at world size 1 did not raise")
        except ValueError as e:
            if "mesh (2 data x 1 model) needs 2 devices but only 1" not in str(e):
                raise
            refused = str(e)
        finally:
            for k in env:
                os.environ.pop(k, None)
    finally:
        parallel.maybe_init_distributed = real_init
        probe.close()
    log("data_parallel", f"python -m ffrnet_torch.train under FFRNET_DISTRIBUTED=1 RANK=0 "
        f"WORLD_SIZE=1: joined {joined[0][1]} on {joined[0][0]} with a gloo host group; 4 steps "
        f"and an eval, launches as phase 9's; checkpoints {names_d} (one writer), latest "
        f"parameters within {err:.3e} of the one-process run (tol {TRAIN_PARAM_ATOL}), running "
        f"stats {stats:.3e} (reported); --mesh_data 2 "
        f"raised: {refused}")
    return total


def dp_shard(models, card):
    """(d) FFRNet.shard() over the visible card bit-equal to embed; over
    cuda:0 twice (the split, pad and gather on the card) within PATH_TOL,
    with two forwards' launches a call; an EmbeddingService over it."""
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
    from ffrnet_torch.serving import EmbeddingService

    model = models["fused"]
    faces = torch.randint(0, 256, (max(SHARD_NS), 112, 112, 3), generator=gen(140),
                          dtype=torch.uint8).numpy()
    one, two = model.shard(), model.shard(["cuda:0", "cuda:0"])
    if one.devices != (torch.device("cuda", 0),) or len(two.replicas) != 1:
        raise AssertionError(f"shard: devices {one.devices}, {two.devices}")
    total = {k: 0 for k in KERNELS}
    errs = []
    for n in SHARD_NS:
        want = model.embed(faces[:n])
        for name, sharded, forwards in (("shard()", one, 1), ("shard(cuda:0 x2)", two, 2)):
            torch.cuda.synchronize()
            reset_launch_counts()
            got = sharded.embed(faces[:n])
            torch.cuda.synchronize()
            counts = launch_counts()
            expected = {k: DRIVER_COUNTS["fused", "eval"].get(k, 0) * forwards for k in KERNELS}
            if counts != expected:
                raise AssertionError(f"{name} N={n}: launches {counts}, expected {expected}")
            for k in total:
                total[k] += counts[k]
            if forwards == 1:
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{name} N={n}: not bit-equal to embed")
            else:
                errs.append(max(check_close(f"{name} N={n}", a, b, *PATH_TOL)
                                for a, b in zip(got, want)))
    x = faces[:SERVE_POOL]
    want = model.embed(x)[0]
    with EmbeddingService(two, max_batch=16) as svc:
        futs = [svc.submit(x[i:i + 1 + i % 3]) for i in range(0, SERVE_POOL - 3, 3)]
        outs = [f.result(timeout=120) for f in futs]
    serve_err = max(check_close("EmbeddingService over shard(cuda:0 x2)", raw.cpu(),
                                want[i:i + len(raw)].cpu(), *PATH_TOL)
                    for (raw, _), i in zip(outs, range(0, SERVE_POOL - 3, 3)))
    log("data_parallel", f"FFRNet.shard() over {one.devices}: bit-equal to embed at N="
        f"{', '.join(map(str, SHARD_NS))}, one forward's launches a call; shard over cuda:0 "
        f"twice (padded to even, split, gathered): max_abs_err {max(errs):.3e} (tol {PATH_TOL}), "
        f"two forwards' launches a call; EmbeddingService(max_batch=16) over it, {len(outs)} "
        f"groups of 1-3 faces vs a direct embed: max_abs_err {serve_err:.3e}")
    return total


def phase_data_parallel(models, dev, card):
    """Phase 13 -> the launch counts of its counted runs, summed."""
    import tempfile

    t0 = time.perf_counter()
    total = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory(prefix="ffrnet_dp_") as root:
        tree = os.path.join(root, "faces")
        driver_tree(tree)
        for part in (dp_steps_and_eval(tree, dev, card), dp_driver(tree, root, card),
                     dp_shard(models, card)):
            for k, v in part.items():
                total[k] += v
    torch.cuda.empty_cache()
    log("data_parallel", f"all data-parallel checks passed in {time.perf_counter() - t0:.1f} s "
        f"| {card}")
    return total


# ----------------------------------------------------------------- phase 14

TP_BATCH, TP_STEPS = 64, 2
# SGD with momentum, as phase 13 (the update is linear in the gradient);
# the momentum buffer is the padded row's optimizer state
TP_OPT = dict(optimizer="sgd", lr=1e-3, momentum=0.9)
# the JAX package's tensor-parallel bound (tests/test_training.py:716)
TP_PARAM_ATOL = 2e-5
# (RecNet configuration, step, (data, model) mesh, launches per rank per step)
TP_KINDS = (("fused", "train_step", (1, 2), {"se_gating": 24}),
            ("ss_kernel", "train_step_from_features", (2, 2), {"self_similarity": 7}))


def tp_digest(trees):
    """sha256 of a (state dict, optimizer state by key) pair, on the CPU."""
    import hashlib

    sd, opt = trees
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].detach().cpu().contiguous().numpy().tobytes())
    for k in sorted(opt):
        for e in sorted(opt[k]):
            v = opt[k][e]
            h.update(f"{k}/{e}".encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes() if torch.is_tensor(v)
                     else repr(v).encode())
    return h.hexdigest()


def tp_replicated_checksum(state):
    import hashlib

    h = hashlib.sha256()
    for k, v in state.model.state_dict().items():
        if k != "classifier.weight":
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def tp_run(step, state, batches, d, n_data, world):
    """The updates of one rank on its data coordinate's shard -> per step
    (host ms, launches, metrics averaged over every rank, replicated
    checksum), the state."""
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
    from ffrnet_torch.parallel.collectives import average_tensor

    out = []
    for b in batches:
        n = len(b["label"]) // n_data
        local = {k: v[d * n:(d + 1) * n] for k, v in b.items()}
        torch.cuda.synchronize()
        reset_launch_counts()
        t = time.perf_counter()
        state, m = step(state, local)
        torch.cuda.synchronize()
        ms, counts = (time.perf_counter() - t) * 1e3, launch_counts()
        metrics = {k: float(v) if k == "LR" or world == 1 else float(average_tensor(
            v.float(), torch.distributed.group.WORLD)) for k, v in m.items()}
        out.append((ms, counts, metrics, tp_replicated_checksum(state)))
    return out, state


def tp_shard_record(state):
    """This rank's class shard: offset, rows, sha256 of its rows, and
    whether its padded rows and their momentum are exactly 0."""
    import hashlib

    p = state.model.classifier.weight
    num, off = state.model.cfg.num_classes, state.model.classifier.class_offset
    real = min(max(num - off, 0), p.shape[0])
    buf = state.optimizer.inner.state[p]["momentum_buffer"]
    return {"offset": off, "rows": p.shape[0], "padded": p.shape[0] - real,
            "sha": hashlib.sha256(p.detach().cpu().numpy().tobytes()).hexdigest(),
            "zero": bool((p[real:] == 0).all()) and bool((buf[real:] == 0).all())}


def tp_rank(rank, world, port, path):
    """One rank of phase 14 on cuda:0 under a gloo group. World 4: the
    ss_kernel feature step on a 2x2 mesh for TP_STEPS updates, then
    save_orbax of its state. World 2: the fused train_step on a 1x2 mesh;
    then the 2x2 checkpoint loaded and bound under 1x2 and one more
    feature update. Writes path.<world>.<rank>."""
    import torch.distributed as dist

    from ffrnet_torch import parallel
    from ffrnet_torch.checkpoint.orbax_io import (load_orbax, save_orbax,
                                                  state_dicts_from_tree, train_state_tree)
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.training.trainer import (create_train_state, gather_train_state,
                                               load_train_state, make_distributed_feature_step,
                                               make_distributed_step)

    if not torch.cuda.is_available():
        raise RuntimeError(f"phase 14 rank {rank}: no card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    inp = torch.load(path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        res = {}
        name, what, shape, _ = TP_KINDS[1] if world == 4 else TP_KINDS[0]
        mesh = parallel.make_mesh(*shape)
        d, _ = parallel.mesh_coordinate(mesh)
        cfg = train_cfg(name, **TP_OPT)
        state = create_train_state(cfg, seed=1, device=dev)
        if what == "train_step":
            enc = build_backbone(generator=gen(0)).to(dev).eval()
            bound, (enc, state) = make_distributed_step(mesh, cfg, enc, state)
            step, batches = functools.partial(bound, enc), inp["batches"]
        else:
            step, state = make_distributed_feature_step(mesh, cfg, state)
            batches = [{k: v.to(dev) for k, v in f.items()} for f in inp["feats"][:TP_STEPS]]
        res["steps"], state = tp_run(step, state, batches, d, shape[0], world)
        res["shard"] = tp_shard_record(state)
        trees = gather_train_state(state, parallel.model_group(mesh))
        res["digest"] = tp_digest(trees)
        if rank == 0:
            res["state"] = trees[0]
        if world == 4:
            tree = train_state_tree(state, mesh, epoch=0, iteration=TP_STEPS)
            torch.cuda.synchronize()
            t = time.perf_counter()
            save_orbax(inp["ckpt"], TP_STEPS, tree)
            res["save_ms"] = (time.perf_counter() - t) * 1e3
        else:  # resume the 2x2 ss_kernel checkpoint under 1x2
            del state, step, bound, enc
            cfg = train_cfg("ss_kernel", **TP_OPT)
            t = time.perf_counter()
            sd, opt, meta = state_dicts_from_tree(load_orbax(inp["ckpt"]))
            res["load_ms"] = (time.perf_counter() - t) * 1e3
            state = load_train_state(create_train_state(cfg, seed=2, device=dev), sd, opt,
                                     meta["iter"])
            step, state = make_distributed_feature_step(mesh, cfg, state)
            res["loaded_digest"] = tp_digest(gather_train_state(state, parallel.model_group(mesh)))
            res["loaded_shard"] = tp_shard_record(state)
            feats = [{k: v.to(dev) for k, v in inp["feats"][TP_STEPS].items()}]
            res["resumed_steps"], state = tp_run(step, state, feats, d, 1, world)
            trees = gather_train_state(state, parallel.model_group(mesh))
            if rank == 0:
                res["resumed_state"] = trees[0]
        torch.save(res, f"{path}.{world}.{rank}")
    finally:
        dist.destroy_process_group()


def tp_check_steps(what, ranks, ref_steps, want):
    """The ranks' updates against one process: launches per rank per step,
    equal checksums and metrics on every rank, losses 1e-4 rel, TrainAcc
    equal. -> the expected launches."""
    expected = {k: want.get(k, 0) for k in KERNELS}
    for r, res in enumerate(ranks):
        for i, (_, counts, m, sums) in enumerate(res):
            if counts != expected:
                raise AssertionError(f"model axis {what} rank {r} step {i}: launches {counts}, "
                                     f"expected {expected}")
            if (m, sums) != (ranks[0][i][2], ranks[0][i][3]):
                raise AssertionError(f"model axis {what} rank {r} step {i}: metrics or "
                                     "replicated checksum differ from rank 0's")
    for (_, _, m, _), (_, _, m_ref, _) in zip(ranks[0], ref_steps):
        for k in m_ref:
            if k == "TrainAcc" and m[k] != m_ref[k]:
                raise AssertionError(f"model axis {what}: TrainAcc {m[k]} vs one process "
                                     f"{m_ref[k]}")
            if abs(m[k] - m_ref[k]) > TRAIN_LOSS_RTOL * abs(m_ref[k]) + 1e-6:
                raise AssertionError(f"model axis {what}: {k} {m[k]} vs one process {m_ref[k]}")
    return expected


def tp_compare_state(what, sd, ref_sd):
    params = [k for k in ref_sd if "running" not in k and ref_sd[k].is_floating_point()]
    err = max(check_close(f"model axis {what} {k} vs one process", sd[k], ref_sd[k],
                          TP_PARAM_ATOL, 0.0) for k in params)
    stats = max((sd[k].float() - ref_sd[k].float()).abs().max().item()
                for k in ref_sd if "running" in k)
    return err, stats


def tp_check_shards(what, shards, n_model):
    """Rows 5288 a rank at offsets 5288 j, the padded row (model rank M-1's
    last) and its momentum exactly 0, the shards equal across the data
    axis."""
    from ffrnet_torch.parallel import class_shard

    for r, sh in enumerate(shards):
        j = r % n_model
        off, rows = class_shard(10575, n_model, j)
        if (sh["offset"], sh["rows"]) != (off, rows) or not sh["zero"]:
            raise AssertionError(f"model axis {what} rank {r}: shard {sh}, expected offset "
                                 f"{off}, {rows} rows, padding exactly 0")
        if sh["sha"] != shards[j]["sha"]:
            raise AssertionError(f"model axis {what} rank {r}: class shard differs across the "
                                 "data axis")
    if shards[n_model - 1]["padded"] != 1:
        raise AssertionError(f"model axis {what}: {shards[n_model - 1]['padded']} padded rows")


def tp_label(model, feats, batch):
    """Each sample of one global batch whose masked branch ranks one class
    first by a margin of 1e-3 under `model` (train mode, as the step will
    run it) takes that class as its label, in `feats` and `batch` alike ->
    how many. TrainAcc is then not 0 and holds the sharded argmax, and the
    margin keeps the runs' summation-order noise (about 1e-7) off its ties."""
    import copy

    rec = copy.deepcopy(model)  # a train-mode forward moves the running stats
    with torch.no_grad():
        out = rec(feats["featmap_ocl"].to(rec.classifier.weight.device),
                  feats["label"].to(rec.classifier.weight.device))
    top = out.cosine.topk(2, dim=1)
    sure = ((top.values[:, 0] - top.values[:, 1]) > 1e-3).cpu()
    batch["label"][sure] = feats["label"][sure] = top.indices[:, 0].cpu()[sure]
    return int(sure.sum())


def tp_io_ms(state, root):
    """save_orbax, load_orbax and a pth save of the whole train state in one
    process, twice each -> their ms."""
    from ffrnet_torch.checkpoint.orbax_io import load_orbax, save_orbax, train_state_tree
    from ffrnet_torch.checkpoint.store import save_checkpoint
    from ffrnet_torch.parallel import make_mesh
    from ffrnet_torch.training.trainer import gather_train_state

    os.makedirs(root)
    trees = gather_train_state(state)
    io_ms = {"save_orbax": [], "load_orbax": [], "pth save": []}
    for i in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        save_orbax(root, i, train_state_tree(state, make_mesh(), epoch=0, iteration=i))
        io_ms["save_orbax"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        load_orbax(root, i)
        io_ms["load_orbax"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        save_checkpoint(root, f"pth{i}", model=trees[0], optimizer=trees[1])
        io_ms["pth save"].append((time.perf_counter() - t) * 1e3)
    return io_ms


def tp_steps_and_checkpoint(tree, dev, card):
    """(a) and (b): the sharded steps against one process, and the 2x2
    checkpoint loaded under 1x2 and in one process. -> launches."""
    import torch.multiprocessing as mp

    from ffrnet_torch.checkpoint.orbax_io import load_orbax, state_dicts_from_tree
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.training.trainer import (create_train_state, encode_frozen,
                                               load_train_state, train_step,
                                               train_step_from_features)

    enc = build_backbone(generator=gen(0)).to(dev).eval()
    batches = [image_batch(TP_BATCH, 150 + i) for i in range(TP_STEPS + 1)]
    feats = [{k: v.cpu() for k, v in encode_frozen(enc, b).items()} for b in batches]

    def state_dict_of(state):
        return {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}

    # one process on the whole batches: ss_kernel 3 updates, each batch
    # labelled first by tp_label under the state that takes it; then fused 2
    ref, picked = {}, []
    cfg = train_cfg("ss_kernel", **TP_OPT)
    state = create_train_state(cfg, seed=1, device=dev)
    step = functools.partial(train_step_from_features, cfg=cfg)
    steps = []
    for i, (b, f) in enumerate(zip(batches, feats)):
        if i == TP_STEPS:
            ref["ss_kernel"] = (list(steps), state_dict_of(state))
            io_ms = tp_io_ms(state, os.path.join(tree, "tp_one"))
        picked.append(tp_label(state.model, f, b))
        out, state = tp_run(step, state, [{k: v.to(dev) for k, v in f.items()}], 0, 1, 1)
        steps += out
    ref["ss_kernel_3"] = (steps[TP_STEPS:], state_dict_of(state))
    cfg = train_cfg("fused", **TP_OPT)
    state = create_train_state(cfg, seed=1, device=dev)
    steps, state = tp_run(functools.partial(train_step, enc, cfg=cfg), state,
                          batches[:TP_STEPS], 0, 1, 1)
    ref["fused"] = (steps, state_dict_of(state))
    del state

    ckpt = os.path.join(tree, "tp_ckpt")
    os.makedirs(ckpt)
    path = os.path.join(tree, "tp_inputs.pt")
    torch.save({"batches": batches[:TP_STEPS], "feats": feats, "ckpt": ckpt}, path)
    spawn_s = {}
    for world in (4, 2):  # the 1x2 ranks load the 2x2 ranks' checkpoint
        t0 = time.perf_counter()
        mp.start_processes(tp_rank, args=(world, dp_free_port(), path), nprocs=world, join=True,
                           start_method="spawn")
        spawn_s[world] = time.perf_counter() - t0
    ranks = {w: [torch.load(f"{path}.{w}.{r}", weights_only=False) for r in range(w)]
             for w in (4, 2)}

    total = {k: 0 for k in KERNELS}
    for (name, what, shape, want), world in zip(TP_KINDS, (2, 4)):
        res = ranks[world]
        steps = [r["steps"] for r in res]
        expected = tp_check_steps(f"{name} {what} {shape}", steps, ref[name][0], want)
        for st in steps:
            for _, c, _, _ in st:
                for k in total:
                    total[k] += c[k]
        if len({r["digest"] for r in res}) != 1:
            raise AssertionError(f"model axis {name}: the ranks gathered different states")
        tp_check_shards(name, [r["shard"] for r in res], shape[1])
        err, stats = tp_compare_state(f"{name} {shape}", res[0]["state"], ref[name][1])
        s0 = steps[0]
        log("model_axis", f"{name} {what} on a {shape[0]}x{shape[1]} mesh ({world} gloo ranks on "
            f"cuda:0, {TP_BATCH // shape[0]} faces a rank), 10575 classes padded to 10576, "
            f"5288 rows a rank, {TP_STEPS} SGD updates vs one process x {TP_BATCH}: parameters "
            f"max_abs_err {err:.3e} (tol {TP_PARAM_ATOL}), running stats {stats:.3e} "
            f"(reported), losses within {TRAIN_LOSS_RTOL} rel (TotalLoss "
            f"{s0[0][2]['TotalLoss']:.4f}, {s0[-1][2]['TotalLoss']:.4f}), TrainAcc equal "
            f"({s0[-1][2]['TrainAcc']:.4f}); replicated checksums equal on every rank, class "
            f"shards equal across the data axis, the padded row and its momentum exactly 0; "
            f"launches per rank per step { {k: v for k, v in expected.items() if v} }")
        ms = [[f"{x[0]:.1f}" for x in st] for st in steps]
        log("times", f"model axis {name} {what} {shape[0]}x{shape[1]}: step ms per rank "
            f"{'; '.join(f'rank {r}: ' + ', '.join(m) for r, m in enumerate(ms))} (all ranks on "
            f"one card) beside the one-process step ms at N={TP_BATCH} "
            f"({', '.join(f'{x[0]:.1f}' for x in ref[name][0])}; the first step of each "
            f"includes its warm-up) | {card}")

    # the 2x2 checkpoint under 1x2 and in one process
    saved = ranks[4][0]["digest"]
    r2 = ranks[2]
    if any(r["loaded_digest"] != saved for r in r2):
        raise AssertionError("model axis: the 2x2 checkpoint loaded under 1x2 is not bit-equal "
                             "to the saved state")
    tp_check_shards("loaded under 1x2", [r["loaded_shard"] for r in r2], 2)
    t = time.perf_counter()
    tree_1 = load_orbax(ckpt)
    one_load_ms = (time.perf_counter() - t) * 1e3
    sd, opt, meta = state_dicts_from_tree(tree_1)
    if tp_digest((sd, opt)) != saved or meta != {"epoch": 0, "iter": TP_STEPS, "step": TP_STEPS}:
        raise AssertionError(f"model axis: the 2x2 checkpoint in one process is not bit-equal "
                             f"to the saved state ({meta})")
    cfg = train_cfg("ss_kernel", **TP_OPT)
    state = load_train_state(create_train_state(cfg, seed=2, device=dev), sd, opt, meta["iter"])
    step = functools.partial(train_step_from_features, cfg=cfg)
    one, state = tp_run(step, state, [{k: v.to(dev) for k, v in feats[TP_STEPS].items()}], 0, 1,
                        1)
    want = {"self_similarity": 7}
    tp_check_steps("ss_kernel resumed under 1x2", [r["resumed_steps"] for r in r2],
                   ref["ss_kernel_3"][0], want)
    tp_check_steps("ss_kernel resumed in one process", [one], ref["ss_kernel_3"][0], want)
    for st in [r["resumed_steps"] for r in r2]:
        for _, c, _, _ in st:
            for k in total:
                total[k] += c[k]
    err_12, _ = tp_compare_state("resumed under 1x2", r2[0]["resumed_state"],
                                 ref["ss_kernel_3"][1])
    err_1, _ = tp_compare_state("resumed in one process",
                                {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
                                ref["ss_kernel_3"][1])
    log("model_axis", f"labels: {picked} of {TP_BATCH} a batch set to the first class of the "
        "RecNet that takes it (a margin of 1e-3), the rest random")
    log("model_axis", f"save_orbax of the 2x2 ss_kernel state (DCP, each rank its class rows, "
        f"the rest once: {sorted(os.listdir(os.path.join(ckpt, 'orbax_000000002')))}); loaded "
        f"under 1x2 and in one process bit-equal to the saved state (sha256 of the gathered "
        f"state); one more update each vs an uninterrupted {TP_STEPS + 1}-update run: "
        f"parameters max_abs_err {err_12:.3e} (1x2), {err_1:.3e} (one process), tol "
        f"{TP_PARAM_ATOL}; ranks spawned and joined in {spawn_s[4]:.1f} s (2x2), "
        f"{spawn_s[2]:.1f} s (1x2)")
    log("times", f"sharded checkpoint of the full train state (RecNet, 10575 classes, SGD "
        f"momentum): save_orbax in one process {', '.join(f'{x:.1f}' for x in io_ms['save_orbax'])}"
        f" ms, load_orbax {', '.join(f'{x:.1f}' for x in io_ms['load_orbax'])} ms, beside the "
        f"pth save of the same state {', '.join(f'{x:.1f}' for x in io_ms['pth save'])} ms; "
        f"save_orbax by 4 ranks (2x2) {ranks[4][0]['save_ms']:.1f} ms, load_orbax by each of 2 "
        f"ranks {', '.join(f'{r['load_ms']:.1f}' for r in r2)} ms, in one process "
        f"{one_load_ms:.1f} ms | {card}")
    return total


def tp_driver(tree, root, card):
    """(c) python -m ffrnet_torch.train's main under FFRNET_DISTRIBUTED=1,
    RANK=0, WORLD_SIZE=1 (NCCL) with --ckpt_backend orbax: 4 steps, then
    resumed to 8, against an uninterrupted 8-step run; --mesh_model 2
    refused. The state the resume builds is held to the bit against the
    step it loads; the resumed run's step 8 to TP_PARAM_ATOL against the
    uninterrupted run's: RecNet's reflection padding accumulates its
    gradient with atomics on the card, so no two runs of a step are
    bit-equal there (the CPU tests hold the resume to the bit)."""
    from ffrnet_torch.checkpoint.orbax_io import load_orbax
    from ffrnet_torch.config import parse_args
    import ffrnet_torch.train as T

    # lr 1e-4: two runs of a step part through the backward's atomics, and
    # ChannelFlipMerge.0's ill-conditioned gradient carries that into the
    # parameters in proportion to lr (8.1e-6 after 8 steps at lr 1e-3 on an
    # H100 80GB HBM3 at 700 W); the resume's own exactness is the sha256 check
    extra = ("--optimizer", "sgd", "--lr", "1e-4", "--momentum", "0.9", "--ckpt_backend", "orbax")
    env = {"FFRNET_DISTRIBUTED": "1", "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1"}

    def run(argv):
        os.environ.update(env, MASTER_PORT=str(dp_free_port()))
        try:
            T.main(argv)
        finally:
            for k in env:
                os.environ.pop(k, None)
        opts = parse_args(argv, make_dirs=False)
        return opts, sorted(int(d.split("_")[1]) for d in os.listdir(opts.ckpt_dir)
                            if d.startswith("orbax_"))

    restored = []
    real_load = T.load_train_state

    def load_and_check(state, sd, opt, step):
        from ffrnet_torch.training.trainer import gather_train_state

        out = real_load(state, sd, opt, step)
        restored.append((tp_digest(gather_train_state(out)), tp_digest((sd, opt)), step))
        return out

    probe = DriverProbe()
    T.load_train_state = load_and_check
    total = {k: 0 for k in KERNELS}
    try:
        runs = {}
        for name, epochs, more in (("first", "1", ()), ("resumed", "2", ("--continue_train", "1")),
                                   ("whole", "2", ())):
            probe.reset()
            sub = "whole" if name == "whole" else "orbax"
            if name == "resumed":
                at4 = load_orbax(runs["first"][0].ckpt_dir, 4)
            opts, kept = run(driver_argv(tree, os.path.join(root, sub), *extra, "--total_epochs",
                                         epochs, *more))
            check_driver_counts(f"orbax {name} train_step", probe.steps,
                                DRIVER_COUNTS["fused", "train_step"])
            check_driver_counts(f"orbax {name} eval batch", probe.evals,
                                DRIVER_COUNTS["fused", "eval"])
            want = [3, 4] if name == "first" else [4, 7, 8]
            if kept != want or len(probe.steps) != (8 if name == "whole" else 4):
                raise AssertionError(f"driver orbax {name}: steps kept {kept}, expected {want}; "
                                     f"{len(probe.steps)} steps")
            for _, c in probe.steps + probe.evals:
                for k in total:
                    total[k] += c[k]
            runs[name] = (opts, kept)
        from ffrnet_torch.checkpoint.orbax_io import state_dicts_from_tree

        sd4, opt4, _ = state_dicts_from_tree(at4)
        if len(restored) != 1 or restored[0][0] != restored[0][1] or restored[0][1] != tp_digest(
                (sd4, opt4)) or restored[0][2] != 4:
            raise AssertionError(f"driver orbax: the resumed state is not bit-equal to step 4 "
                                 f"({restored})")
        a, b = (load_orbax(runs[n][0].ckpt_dir, 8) for n in ("resumed", "whole"))
        if a.keys() != b.keys() or (a["epoch"], a["iter"], a["step"]) != (b["epoch"], b["iter"],
                                                                        b["step"]):
            raise AssertionError("driver orbax: the resumed run's step 8 holds other entries "
                                 "than the uninterrupted run's")
        params = [k for k in b if k.startswith("params/")]
        err = max(check_close(f"driver orbax resumed {k} vs uninterrupted", a[k], b[k],
                              TP_PARAM_ATOL, 0.0) for k in params)
        others = max((a[k].float() - b[k].float()).abs().max().item() for k in b
                     if torch.is_tensor(b[k]) and k not in params and b[k].is_floating_point())
        try:
            run(driver_argv(tree, os.path.join(root, "mm2"), *extra, "--mesh_model", "2"))
            raise AssertionError("driver --mesh_model 2 at world size 1 did not raise")
        except ValueError as e:
            if "--mesh_model 2 exceeds the 1 visible devices" not in str(e):
                raise
            refused = str(e)
    finally:
        T.load_train_state = real_load
        probe.close()
    log("model_axis", f"python -m ffrnet_torch.train --ckpt_backend orbax under "
        f"FFRNET_DISTRIBUTED=1 RANK=0 WORLD_SIZE=1 (NCCL): 4 steps keep orbax steps "
        f"{runs['first'][1]}, resumed with --continue_train 1 --total_epochs 2 keep "
        f"{runs['resumed'][1]}; the resumed state bit-equal to step 4 (sha256); step 8 vs an "
        f"uninterrupted 8-step run: parameters max_abs_err {err:.3e} (tol {TP_PARAM_ATOL}), "
        f"running stats and momentum {others:.3e} (reported); launches as phase 9's; "
        f"--mesh_model 2 raised: {refused}")
    return total


def phase_model_axis(dev, card):
    """Phase 14 -> the launch counts of its counted runs, summed."""
    import tempfile

    t0 = time.perf_counter()
    total = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory(prefix="ffrnet_tp_") as root:
        tree = os.path.join(root, "faces")
        driver_tree(tree)
        for part in (tp_steps_and_checkpoint(tree, dev, card), tp_driver(tree, root, card)):
            for k, v in part.items():
                total[k] += v
    torch.cuda.empty_cache()
    log("model_axis", f"all model-axis checks passed in {time.perf_counter() - t0:.1f} s "
        f"| {card}")
    return total


# ----------------------------------------------------------------- phase 15

# IR-SE50's SE shapes (C, H) and the reference's SELayer(64, 16) on a 7x7 map
EXTRAS_SE_SHAPES = ((64, 56), (128, 28), (256, 14), (512, 7), (64, 7))
# (depth, input shape, c_out) of the HGBlock checks: RecNet's map (7 -> 4 ->
# 2 -> 4 -> 8, resized to 7) and a 56x56 map four levels deep (7 -> 4 -> 8,
# resized to 7, at level 1)
EXTRAS_HG = ((2, (256, 512, 7, 7), 512), (4, (64, 64, 56, 56), 64))
EXTRAS_N = 256
EXTRAS_CLASSES = 51332  # the reference's Arcface / Am_softmax default
EXTRAS_MIN_COS = 0.999
EXTRAS_STEPS = 20


def counts_are(what, counts, **want):
    expected = {k: want.get(k, 0) for k in KERNELS}
    if counts != expected:
        raise AssertionError(f"{what}: launches {counts}, expected {expected}")


def random_bn_stats(model, g):
    """Running means ~ N(0, 0.3), variances ~ U(0.5, 1.5), as
    tests/test_parity_extras.py:19-22 sets the reference's."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.copy_(0.3 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))


def extras_se_layer(dev, g):
    """SELayer (x + se_gating(x, fc.0, fc.2)) on the card against x +
    se_gating_plain at se_gating's tolerances, one launch per call."""
    from ffrnet_torch.models.hourglass import SELayer, init_se_layer
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
    from ffrnet_torch.ops.kernels.se_gating import _se_plan, se_gating_plain

    for dname, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        tol = TOL.get((dname, "se_gating"), BF16_TOL)
        for c, h in EXTRAS_SE_SHAPES:
            layer = SELayer(c, reduction=16)
            init_se_layer(layer, g)
            layer = layer.to(dev, dt)
            x = torch.randn(64, c, h, h, generator=g).to(dev, dt)
            torch.cuda.synchronize()
            reset_launch_counts()
            with torch.no_grad():
                y = layer(x)
            torch.cuda.synchronize()
            counts_are(f"SELayer({c}, 16) {dname}", launch_counts(), se_gating=1)
            with torch.no_grad():
                want = x + se_gating_plain(x, layer.fc[0].weight, layer.fc[2].weight)
            e = check_close(f"SELayer({c}, 16) {dname} {tuple(x.shape)}", y, want, *tol)
            log("extras", f"SELayer({c}, 16) {dname} x{tuple(x.shape)}: one se_gating launch, "
                f"plan {_se_plan(c, h * h, c // 16, dt.itemsize)}, max_abs_err {e:.3e} against "
                f"x + se_gating_plain (atol {tol[0]}, rtol {tol[1]})")


def extras_hgblock(dev, g):
    """HGBlock in eval mode (random BN statistics), fp32 with TF32 off: the
    card against the CPU within PATH_TOL."""
    from ffrnet_torch.models.hourglass import HGBlock, init_hgblock
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts

    for depth, shape, c_out in EXTRAS_HG:
        block = HGBlock(depth, shape[1], c_out, c_mid=64)
        init_hgblock(block, g)
        random_bn_stats(block, g)
        block.eval()
        x = torch.randn(shape, generator=g)
        with torch.no_grad():
            want = block(x)
            block.to(dev)
            torch.cuda.synchronize()
            reset_launch_counts()
            got = block(x.to(dev))
            torch.cuda.synchronize()
        counts_are(f"HGBlock depth {depth}", launch_counts())
        e = check_close(f"HGBlock depth {depth} {shape}", got.cpu(), want, *PATH_TOL)
        log("extras", f"HGBlock(depth={depth}, c_in={shape[1]}, c_out={c_out}, c_mid=64) "
            f"x{shape} -> {tuple(got.shape)}: card vs CPU max_abs_err {e:.3e} (atol "
            f"{PATH_TOL[0]}, rtol {PATH_TOL[1]}; the nearest-exact resize taken)")


def extras_mobilefacenet(dev, g, card):
    """MobileFaceNet(512) at N=256 (random BN statistics) on the card
    against the CPU: fp32 within PATH_TOL, bf16 by cosine; faces/s, the
    median of 10 forwards timed with CUDA events."""
    import copy

    from ffrnet_torch.models.mobilefacenet import build_mobilefacenet
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts

    cpu = build_mobilefacenet(512, generator=g)
    random_bn_stats(cpu, g)
    faces = torch.rand(EXTRAS_N, 3, 112, 112, generator=g) * 2 - 1
    for dname, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        ref = copy.deepcopy(cpu).to(dtype=dt)
        model = copy.deepcopy(cpu).to(dev, dt)
        x = faces.to(dev, dt)
        with torch.no_grad():
            want = ref(faces.to(dt))
            torch.cuda.synchronize()
            reset_launch_counts()
            got = model(x)
            torch.cuda.synchronize()
            counts_are(f"MobileFaceNet {dname}", launch_counts())
            if dname == "fp32":
                e = check_close(f"MobileFaceNet fp32 N={EXTRAS_N}", got.cpu(), want, *PATH_TOL)
                agree = f"max_abs_err {e:.3e} (atol {PATH_TOL[0]}, rtol {PATH_TOL[1]})"
            else:
                cos = min_cos(got, want)
                if not (torch.isfinite(got).all() and cos >= EXTRAS_MIN_COS):
                    raise AssertionError(f"MobileFaceNet bf16: min cosine {cos:.6f} below "
                                         f"{EXTRAS_MIN_COS}")
                agree = f"min cosine {cos:.6f} (>= {EXTRAS_MIN_COS})"
            ms = []
            for _ in range(12):
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                model(x)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
        med = float(np.median(ms[2:]))
        log("extras", f"MobileFaceNet(512) {dname} N={EXTRAS_N}: card vs CPU {agree}; "
            f"{EXTRAS_N / med * 1e3:.1f} faces/s (median {med:.4f} ms of 10 forwards after 2, "
            f"min {min(ms[2:]):.4f}, max {max(ms[2:]):.4f}; CUDA events) | {card}")


def extras_heads(dev, g):
    """Arcface and AmSoftmax at 51332 classes, N=256, fp32 with TF32 off:
    the card against the CPU within PATH_TOL; a quarter of the rows point
    away from their class, so Arcface's [0, pi] guard runs."""
    import copy

    from ffrnet_torch.models.heads import AmSoftmax, Arcface

    label = torch.randint(0, EXTRAS_CLASSES, (EXTRAS_N,), generator=g)
    for cls in (Arcface, AmSoftmax):
        head = cls(512, EXTRAS_CLASSES, generator=g)
        emb = torch.randn(EXTRAS_N, 512, generator=g)
        with torch.no_grad():
            k = EXTRAS_N // 4
            emb[:k] = -head.kernel[:, label[:k]].T + 0.05 * torch.randn(k, 512, generator=g)
            emb = emb / emb.norm(dim=1, keepdim=True)
            want = head(emb, label)
            card = copy.deepcopy(head).to(dev)
            got = card(emb.to(dev), label.to(dev))
            torch.cuda.synchronize()
        e = check_close(f"{cls.__name__} N={EXTRAS_N} classes {EXTRAS_CLASSES}", got.cpu(),
                        want, *PATH_TOL)
        log("extras", f"{cls.__name__}(512, {EXTRAS_CLASSES}) s={head.s} m={head.m} "
            f"N={EXTRAS_N} ({k} rows past the guard): logits {tuple(got.shape)}, card vs CPU "
            f"max_abs_err {e:.3e} (atol {PATH_TOL[0]}, rtol {PATH_TOL[1]})")


def run_captured(fn, argv):
    """fn(argv) with its standard output captured -> (its return value,
    its printed lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(argv)
    return ret, buf.getvalue().strip().splitlines()


def extras_train_synthetic(card):
    """examples/train_synthetic's main, 20 bf16 steps on the card: finite
    losses, 24 se_gating per step. -> its launch counts."""
    from ffrnet_torch.examples import train_synthetic
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_launch_counts()
    _, lines = run_captured(train_synthetic.main, [str(EXTRAS_STEPS)])
    torch.cuda.synchronize()
    counts = launch_counts()
    counts_are(f"train_synthetic {EXTRAS_STEPS} steps", counts,
                      se_gating=24 * EXTRAS_STEPS)
    losses = [float(line.split("total=")[1].split()[0]) for line in lines]
    printed = [i for i in range(EXTRAS_STEPS) if i % 5 == 0 or i == EXTRAS_STEPS - 1]
    if len(losses) != len(printed) or not np.isfinite(losses).all():
        raise AssertionError(f"train_synthetic: printed {lines}")
    for line in lines:
        log("extras", f"train_synthetic | {line}")
    log("extras", f"train_synthetic: {EXTRAS_STEPS} bf16 steps (batch 16, 32 identities, Adam "
        f"lr 1e-3) in {time.perf_counter() - t0:.1f} s with the build; TotalLoss "
        f"{losses[0]:.4f} at step 0 -> {losses[-1]:.4f} at step {EXTRAS_STEPS - 1}; "
        f"launches {counts} | {card}")
    return counts


def extras_bench_eval(card):
    """tools/bench_eval at its defaults (6,000 pairs, batch 250, bf16, 3
    repeats after the first pass), then with --sync_per_batch: each pass
    launches se_gating 24 times and channel_branch once per batch. -> the
    launch counts of both runs."""
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
    from ffrnet_torch.tools import bench_eval

    total = {k: 0 for k in KERNELS}
    for extra in ([], ["--sync_per_batch"]):
        torch.cuda.synchronize()
        reset_launch_counts()
        out, _ = run_captured(bench_eval.main, extra)
        torch.cuda.synchronize()
        counts = launch_counts()
        forwards = -(-out["pairs"] // out["batch"]) * (1 + len(out["all_times"]))
        counts_are(f"bench_eval {extra}", counts, se_gating=24 * forwards,
                          channel_branch=forwards)
        for k, v in counts.items():
            total[k] += v
        log("extras", f"bench_eval {' '.join(extra) or '(defaults)'}: {out['pairs']} pairs, "
            f"batch {out['batch']}, {out['dtype']}: {out['pairs_per_sec']} pairs/s (best pass "
            f"{out['value']} s of {out['all_times']}); {forwards} encoder+RecNet forwards "
            f"of 2x{out['batch']} faces -> {counts} | {card}")
        log("extras", f"bench_eval | {json.dumps(out)}")
    torch.cuda.empty_cache()
    return total


def extras_bench_driver(card):
    """tools/bench_driver at its defaults (fp32, batch 128, 30 steps after 1
    + 3), then with --upload_only 1: 24 se_gating per step, none without
    steps. -> the launch counts of both runs."""
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
    from ffrnet_torch.tools import bench_driver

    total = {k: 0 for k in KERNELS}
    for extra, steps in (([], 1 + 3 + 30), (["--upload_only", "1"], 0)):
        torch.cuda.synchronize()
        reset_launch_counts()
        out, _ = run_captured(bench_driver.main, extra)
        torch.cuda.synchronize()
        counts = launch_counts()
        counts_are(f"bench_driver {extra}", counts, se_gating=24 * steps)
        for k, v in counts.items():
            total[k] += v
        log("extras", f"bench_driver {' '.join(extra) or '(defaults)'}: {out['value']} imgs/s, "
            f"{out['ms_per_iter']} ms per iteration (batch {out['batch']}, {out['dtype']}, "
            f"{out['mb_per_batch']} MB uint8 a batch); {steps} train steps -> {counts} | {card}")
        log("extras", f"bench_driver | {json.dumps(out)}")
    torch.cuda.empty_cache()
    return total


def phase_extras(dev, card):
    """Phase 15 -> the launch counts of its example and tool runs, summed
    (the module checks' launches are comparisons, checked but not summed)."""
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = gen(160)
    extras_se_layer(dev, g)
    extras_hgblock(dev, g)
    extras_mobilefacenet(dev, g, card)
    extras_heads(dev, g)
    total = {k: 0 for k in KERNELS}
    for part in (extras_train_synthetic(card), extras_bench_eval(card),
                 extras_bench_driver(card)):
        for k, v in part.items():
            total[k] += v
    torch.cuda.empty_cache()
    log("extras", f"all extras checks passed in {time.perf_counter() - t0:.1f} s; launches of "
        f"the example and tool runs {total} | {card}")
    return total


# ----------------------------------------------------------------- phase 16

# the JAX tools' committed artifacts, which no port tool may write
TRACKED_INT8_FILES = (".int8_scales.json", "docs/int8_budget.json", "docs/int8_convergence.json")
TOOLS_SYNTH_IDS = 64
TOOLS_CACHE_N = 256
# (rounds, calls a round) of the duel tools: their defaults
TOOLS_BENCH_INT8_RUNS, TOOLS_RECNET_RUNS = (3, 8), (3, 10)
TOOLS_BENCH_INT8 = ["--batches", "128,256,512", "--margins", "0.5,0.75,1.0,1.25"]
TOOLS_RECNET = ["--batch", "256"]
# the horizons cut from 3 seeds x 200 steps and 600 steps to keep the phase short
TOOLS_BUDGET = ["--seeds", "3", "--train_steps", "100"]
TOOLS_CONVERGENCE = ["--steps", "300", "--ckpt_every", "100"]


def file_digest(rel):
    import hashlib

    with open(os.path.join(HERE, rel), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class CallLaunches:
    """Wraps `mod.name` so that each call records (tag, launch counts of the
    call): the counts read before and after it, not reset, so the run's
    totals stay whole. `tag(*args)` labels the call. `close()` restores."""

    def __init__(self, mod, name, tag, wrap_result=False):
        from ffrnet_torch.ops.kernels import launch_counts

        self.records, self._mod, self._name = [], mod, name
        self._fn = fn = getattr(mod, name)

        def counted(call, label):
            def run(*a, **k):
                before = launch_counts()
                out = call(*a, **k)
                after = launch_counts()
                self.records.append((label, {n: after[n] - before[n] for n in KERNELS}))
                return out
            return run

        if wrap_result:  # a factory: count the calls of the function it returns
            setattr(mod, name, lambda *a, **k: counted(fn(*a, **k), tag(*a)))
        else:
            setattr(mod, name, lambda *a, **k: counted(fn, tag(*a))(*a, **k))

    def close(self):
        setattr(self._mod, self._name, self._fn)


def tools_synth(dev, card):
    """synth at N=64 on the card: one key one batch, the noise-free
    structure of a batch and of 600 eval pairs, the ms of one draw."""
    from ffrnet_torch.data.datasets import SyntheticPairs
    from ffrnet_torch.tools import synth

    t = torch.from_numpy(SyntheticPairs(num_identities=TOOLS_SYNTH_IDS, seed=7).templates).to(dev)
    make = synth.make_batch_fn(t, 64, TOOLS_SYNTH_IDS, 0.25)
    a, b = make(3), make(3)
    if not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("synth: key 3 gave two batches")
    keep = torch.ones(112, 112, dtype=torch.bool, device=dev)
    keep[synth.MASK] = False
    z = synth.make_batch_fn(t, 64, TOOLS_SYNTH_IDS, 0.0)(4)
    lab = z["label"]
    ocl = z["img_ocl"]
    if not (z["img_non"].equal(t[lab]) and (ocl[:, synth.MASK[0], synth.MASK[1]] == -1).all()
            and ocl[:, keep].equal(t[lab][:, keep]) and lab.dtype == torch.int64):
        raise AssertionError("synth: noise-free batch not the templates with the mask painted")
    img1, img2, plab = synth.make_eval_pairs(t, 5, 600, TOOLS_SYNTH_IDS, 0.0)
    sums = t[:, keep].sum(dim=(1, 2))

    def ids(img):
        return (img[:, keep].sum(dim=(1, 2))[:, None] - sums[None]).abs().argmin(dim=1)

    i1, i2 = ids(img1), ids(img2)
    if not (img1.equal(t[i1]) and img2[:, keep].equal(t[i2][:, keep])
            and (img2[:, synth.MASK[0], synth.MASK[1]] == -1).all()
            and plab.tolist() == [1] * 300 + [0] * 300 and i1[:300].equal(i2[:300])
            and (i1[300:] != i2[300:]).all()):
        raise AssertionError("synth: eval pairs lack the label halves or distinct negatives")
    ms = cuda_ms(lambda: make(11), iters=20)
    log("int8_tools", f"synth: key -> batch bit-equal; noise-free batch and 600 eval pairs "
        f"(300 same, 300 distinct identities, img2 masked) exact; one N=64 draw "
        f"{ms:.4f} ms (CUDA events, mean of 20) | {card}")


def tools_int8_cache(dev, root):
    """static_encoder_tree and static_recnet_tree on the bf16 bench models:
    miss then hit with bit-equal scales and N=256 outputs, each forward's
    launches exact (checked, not summed); an entry with one path removed is
    stale. Logs the miss's and the hit's host time."""
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.models.optimize import fold_backbone_bn
    from ffrnet_torch.models.quantize import quantize_encoder, quantize_recnet
    from ffrnet_torch.models.recnet import build_recnet
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
    from ffrnet_torch.tools import int8_cache as C

    dt = torch.bfloat16
    f = os.path.join(root, "cache_check.json")
    enc = fold_backbone_bn(build_backbone(generator=gen(0))).to(dev, dt)
    rec = build_recnet(generator=gen(1)).to(dev, dt)
    x = C.uniform_faces(TOOLS_CACHE_N, 9, dt, dev)

    def enc_fwd(x):
        return enc(x)[0]

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    with torch.inference_mode():
        fm = enc_fwd(x)
    qenc, qrec = quantize_encoder(enc), quantize_recnet(rec)
    for what, q, sites, key, run, fwd, per_fwd, stale_path in (
            ("encoder", qenc, INT8_ENCODER_SITES, C.encoder_cache_key(qenc, dtype_name="bf16"),
             lambda m, kw: C.static_encoder_tree(m, dt, **kw), lambda m: m(x)[1],
             {"se_gating": 24, "int8_conv": INT8_ENCODER_SITES}, "body/7/res/conv2/w"),
            ("RecNet", qrec, INT8_RECNET_SITES, C.recnet_cache_key(qrec, enc, dtype_name="bf16"),
             lambda m, kw: C.static_recnet_tree(m, enc_fwd, dt, **kw), lambda m: m(fm)[0],
             {"channel_branch": 1, "int8_conv": INT8_RECNET_SITES}, "merge/c/conv/w")):
        kw = dict(cache_file=f, cache_key=key)
        (m1, s1), miss_ms = timed(lambda: run(q, kw))
        (m2, s2), hit_ms = timed(lambda: run(q, kw))
        sc1 = [s.x_scale for _, s in C.quantized_leaf_items(m1)]
        sc2 = [s.x_scale for _, s in C.quantized_leaf_items(m2)]
        torch.cuda.synchronize()
        reset_launch_counts()
        with torch.inference_mode():
            y1, y2 = fwd(m1), fwd(m2)
        torch.cuda.synchronize()
        counts_are(f"int8_cache {what} miss and hit forwards", launch_counts(),
                   **{k: 2 * v for k, v in per_fwd.items()})
        if ((s1, s2) != (C.STATUS_MISS, C.STATUS_HIT) or len(sc1) != sites
                or not all(a.equal(b) for a, b in zip(sc1, sc2)) or not y1.equal(y2)):
            raise AssertionError(f"int8_cache {what}: {s1}, {s2}; scales or N={len(x)} outputs "
                                 f"differ")
        entry = C.load_scales(f, key)
        del entry[stale_path]
        C.save_scales(f, key, entry)
        s3 = run(q, kw)[1]
        if s3 != C.STATUS_STALE:
            raise AssertionError(f"int8_cache {what}: an entry less {stale_path} gave {s3!r}")
        log("int8_tools", f"int8_cache {what} bf16: {s1} in {miss_ms:.1f} ms (a calibration "
            f"pass on 8 faces) -> {s2} in {hit_ms:.1f} ms (host clock), "
            f"{len(sc1)} scales and the N={len(x)} outputs bit-equal, launches {per_fwd} per "
            f"forward; less {stale_path}: {s3}")


def tools_bench_int8(card):
    """bench_int8 on the card: held-out cosines against float, and the
    exact launches of every forward it ran. -> its launch counts."""
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
    from ffrnet_torch.tools import bench_int8
    from ffrnet_torch.utils.profiling import WARMUP

    rounds, calls = TOOLS_BENCH_INT8_RUNS
    torch.cuda.synchronize()
    reset_launch_counts()
    out, _ = run_captured(bench_int8.main, TOOLS_BENCH_INT8 + [
        "--rounds", str(rounds), "--iters", str(calls)])
    torch.cuda.synchronize()
    counts = launch_counts()
    per_arm = rounds * (WARMUP + calls)
    batches = [int(b) for b in out["per_batch"]]
    n_margins = len(out["margin_sweep_heldout"]["margins"])
    # calibration (float sites), then per batch 3 arms' cosine forwards and
    # their timed calls, then the sweep's float forward and one per margin
    forwards = 1 + len(batches) * 3 * (1 + per_arm) + 1 + n_margins
    int8_forwards = len(batches) * 2 * (1 + per_arm) + n_margins
    counts_are("bench_int8", counts, se_gating=24 * forwards,
               int8_conv=INT8_ENCODER_SITES * int8_forwards)
    for b, rec in out["per_batch"].items():
        cos = min(rec["embed_cos_min"], rec["embed_cos_min_static"])
        if cos < INT8_MIN_COS_FLOAT:
            raise AssertionError(f"bench_int8 N={b}: held-out min cosine {cos} below "
                                 f"{INT8_MIN_COS_FLOAT}")
        log("int8_tools", f"bench_int8 {out['dtype']} N={b}: encoder ms float "
            f"{rec['encoder_ms_float']}, dynamic {rec['encoder_ms_int8']} "
            f"(speedup {rec['speedup_dynamic']}, {rec['imgs_per_sec_int8']} imgs/s), static "
            f"{rec['encoder_ms_int8_static']} (speedup {rec['speedup_static']}, "
            f"{rec['imgs_per_sec_static']} imgs/s; float "
            f"{int(b) / rec['encoder_ms_float'] * 1e3:.1f}); held-out cosine mean/min dynamic {rec['embed_cos_mean']:.5f}/"
            f"{rec['embed_cos_min']:.5f}, static {rec['embed_cos_mean_static']:.5f}/"
            f"{rec['embed_cos_min_static']:.5f} | {card}")
    sweep = out["margin_sweep_heldout"]
    log("int8_tools", f"bench_int8 margin sweep N={sweep['batch']}: " + ", ".join(
        f"{m}: {v['cos_mean']:.5f}/{v['cos_min']:.5f}" for m, v in sweep["margins"].items())
        + f"; {forwards} forwards, {int8_forwards} int8 -> {counts}")
    log("int8_tools", f"bench_int8 | {json.dumps(out)}")
    return counts


def tools_bench_int8_recnet(card):
    """bench_int8_recnet at its defaults: isolated cosines, and the exact
    launches (a band warp per pipeline call). -> its launch counts."""
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
    from ffrnet_torch.tools import bench_int8_recnet
    from ffrnet_torch.tools.int8_cache import STATUS_MISS
    from ffrnet_torch.utils.profiling import WARMUP

    rounds, calls = TOOLS_RECNET_RUNS
    torch.cuda.synchronize()
    reset_launch_counts()
    out, _ = run_captured(bench_int8_recnet.main, TOOLS_RECNET + [
        "--rounds", str(rounds), "--iters", str(calls)])
    torch.cuda.synchronize()
    counts = launch_counts()
    if (out["recnet_scales_cache"], out["enc_scales_cache"]) != (STATUS_MISS, STATUS_MISS):
        raise AssertionError(f"bench_int8_recnet: caches {out['recnet_scales_cache']}, "
                             f"{out['enc_scales_cache']} in a fresh file")
    per_arm = rounds * (WARMUP + calls)
    pipe_calls = 2 * per_arm * len(out["pipeline"])
    # RecNet's calibration (its encoder forward, one float RecNet forward),
    # the held-out feature maps, the 3 cosine forwards and the timed
    # isolated calls; the encoder's calibration (float sites); the pipeline
    counts_are("bench_int8_recnet", counts,
               se_gating=24 * (1 + 1 + 1 + pipe_calls),
               channel_branch=1 + 3 + 3 * per_arm + pipe_calls,
               warp_affine_band=pipe_calls,
               int8_conv=INT8_RECNET_SITES * (2 + 2 * per_arm)
               + INT8_ENCODER_SITES * pipe_calls + INT8_RECNET_SITES * pipe_calls // 2)
    iso = out["isolated"]
    cos = min(iso["cos_min_dynamic"], iso["cos_min_static"])
    if cos < INT8_MIN_COS_FLOAT:
        raise AssertionError(f"bench_int8_recnet: isolated min cosine {cos} below "
                             f"{INT8_MIN_COS_FLOAT}")
    log("int8_tools", f"bench_int8_recnet {out['dtype']} N={out['batch']} isolated RecNet ms "
        f"float {iso['recnet_ms_bf16']}, dynamic {iso['recnet_ms_dynamic']} (speedup "
        f"{iso['speedup_dynamic']}), static {iso['recnet_ms_static']} (speedup "
        f"{iso['speedup_static']}); rectified cosine mean/min dynamic "
        f"{iso['cos_mean_dynamic']}/{iso['cos_min_dynamic']}, static "
        f"{iso['cos_mean_static']}/{iso['cos_min_static']} | {card}")
    for pb, sec in out["pipeline"].items():
        log("int8_tools", f"bench_int8_recnet pipeline N={pb} (align, static int8 encoder, "
            f"RecNet, pair cosines): {sec['faces_per_sec_rec_bf16']} faces/s with the float "
            f"RecNet ({sec['pipeline_ms_rec_bf16']} ms), {sec['faces_per_sec_rec_int8']} with "
            f"the static int8 RecNet ({sec['pipeline_ms_rec_int8']} ms), speedup "
            f"{sec['speedup']}; {2 * per_arm} calls, one band warp each | {card}")
    log("int8_tools", f"bench_int8_recnet: {pipe_calls} pipeline calls -> {counts}")
    log("int8_tools", f"bench_int8_recnet | {json.dumps(out)}")
    return counts


def tools_budget(root, card):
    """bench_int8_budget: finite rows, accuracies in [0, 1], and the exact
    int8_conv launches of each split's scoring. -> its launch counts."""
    from ffrnet_torch.models.quantize import quantized_sites
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
    from ffrnet_torch.tools import bench_int8_budget as B

    def split_of(score_fn, batches):
        ffr = score_fn.__self__
        return tuple(len(quantized_sites(m)) for m in (ffr.encoder, ffr.recnet))

    probe = CallLaunches(B, "evaluate_pairs", split_of)
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        out, _ = run_captured(B.main, TOOLS_BUDGET + ["--out", os.path.join(root, "b.json")])
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        probe.close()
    cfg = out["config"]
    n_batches = -(-cfg["eval_pairs"] // B.EVAL_BATCH)
    want = [(0, 0)] + [(INT8_ENCODER_SITES, 0), (0, INT8_RECNET_SITES),
                       (INT8_ENCODER_SITES, INT8_RECNET_SITES)] * len(cfg["margins"])
    if [s for s, _ in probe.records] != want * cfg["seeds"]:
        raise AssertionError(f"bench_int8_budget: scored splits {[s for s, _ in probe.records]}")
    for (enc_sites, rec_sites), c in probe.records:
        counts_are(f"bench_int8_budget split {enc_sites}+{rec_sites}", c,
                   se_gating=24 * n_batches, channel_branch=n_batches,
                   int8_conv=(enc_sites + rec_sites) * n_batches)
    scorings = len(probe.records)
    # per seed: 24 SE gates a train step, the encoder's calibration pass and
    # RecNet's (one fused forward); then the scorings
    counts_are("bench_int8_budget", counts,
               se_gating=24 * cfg["seeds"] * (cfg["train_steps"] + 1) + 24 * n_batches * scorings,
               channel_branch=cfg["seeds"] + n_batches * scorings,
               int8_conv=sum((e + r) * n_batches for (e, r), _ in probe.records))
    for r in out["rows"]:
        vals = [r[k] for k in ("float_rect", "float_raw", "int8_rect", "int8_raw")]
        if not (np.isfinite(vals + [r["d_rect"], r["d_raw"]]).all()
                and all(0.0 <= v <= 1.0 for v in vals)):
            raise AssertionError(f"bench_int8_budget: row {r}")
    log("int8_tools", f"bench_int8_budget {cfg['dtype']}, {cfg['seeds']} seeds x "
        f"{cfg['train_steps']} steps, {cfg['eval_pairs']} ocl-1 pairs, margins "
        f"{cfg['margins']}: {scorings} scorings in {out['wall_s']} s, each split's int8_conv "
        f"launches exact -> {counts} | {card}")
    for key, v in out["summary"].items():
        log("int8_tools", f"bench_int8_budget summary {key}: worst |d_rect| "
            f"{v['worst_abs_d_rect']}, |d_raw| {v['worst_abs_d_raw']}; mean d_rect "
            f"{v['mean_d_rect']}, d_raw {v['mean_d_raw']}")
    log("int8_tools", f"bench_int8_budget rows | {json.dumps(out['rows'])}")
    return counts


def tools_convergence(root, card):
    """bench_int8_convergence: the int8 arm's steps launch int8_conv 52
    times each, its float-encoder scoring none; finite deltas. -> its
    launch counts."""
    from ffrnet_torch.models.quantize import quantized_sites
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
    from ffrnet_torch.tools import bench_int8_convergence as V

    def int8_encoder(encoder, *_):
        return len(quantized_sites(encoder)) > 0

    steps = CallLaunches(V, "train_step", int8_encoder)
    scores = CallLaunches(V, "make_pair_score_fn", int8_encoder, wrap_result=True)
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        out, _ = run_captured(V.main, TOOLS_CONVERGENCE + ["--out",
                                                          os.path.join(root, "c.json")])
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        scores.close()
        steps.close()
    cfg = out["config"]
    n_ckpt = len(out["deltas_int8_minus_float"])
    if [q for q, _ in steps.records] != [False] * cfg["steps"] + [True] * cfg["steps"]:
        raise AssertionError("bench_int8_convergence: the arms' steps out of order")
    for q, c in steps.records:
        counts_are(f"bench_int8_convergence {'int8' if q else 'float'} step", c, se_gating=24,
                   int8_conv=INT8_ENCODER_SITES if q else 0)
    if [q for q, _ in scores.records] != [False] * n_ckpt + [False, True] * n_ckpt:
        raise AssertionError("bench_int8_convergence: checkpoint scorings out of order")
    for q, c in scores.records:
        counts_are(f"bench_int8_convergence {'arm-encoder' if q else 'float-encoder'} scoring",
                   c, se_gating=24, channel_branch=1, int8_conv=INT8_ENCODER_SITES if q else 0)
    counts_are("bench_int8_convergence", counts,
               se_gating=24 * (1 + 2 * cfg["steps"] + 3 * n_ckpt), channel_branch=3 * n_ckpt,
               int8_conv=INT8_ENCODER_SITES * (cfg["steps"] + n_ckpt))
    deltas = [[d[k] for k in ("d_eval_rect", "d_eval_raw", "d_TrainAcc")]
              for d in out["deltas_int8_minus_float"]]
    if not np.isfinite(deltas).all():
        raise AssertionError(f"bench_int8_convergence: deltas {deltas}")
    for name, curve in out["arms"].items():
        log("int8_tools", f"bench_int8_convergence {name} | {json.dumps(curve)}")
    log("int8_tools", f"bench_int8_convergence {cfg['dtype']} {cfg['steps']} steps: deltas "
        f"int8 - float {json.dumps(out['deltas_int8_minus_float'])}; int8 steps 52 int8_conv "
        f"each, float-encoder scoring none; {out['wall_s']} s -> {counts} | {card}")
    return counts


def phase_int8_tools(dev, card):
    """Phase 16 -> the launch counts of its tool runs, summed (synth
    launches no kernel; the cache check's forwards are checked, not
    summed). The scale cache and every --out go to a temporary directory;
    the JAX tools' tracked files keep their bytes."""
    import tempfile

    from ffrnet_torch.tools import int8_cache

    t0 = time.perf_counter()
    before = {f: file_digest(f) for f in TRACKED_INT8_FILES}
    tools_synth(dev, card)
    total = {k: 0 for k in KERNELS}
    default_file = int8_cache.default_cache_file
    with tempfile.TemporaryDirectory(prefix="ffrnet_int8_tools_") as root:
        int8_cache.default_cache_file = lambda: os.path.join(root, "scales.json")
        try:
            tools_int8_cache(dev, root)
            for part in (tools_bench_int8(card), tools_bench_int8_recnet(card),
                         tools_budget(root, card), tools_convergence(root, card)):
                for k, v in part.items():
                    total[k] += v
        finally:
            int8_cache.default_cache_file = default_file
    after = {f: file_digest(f) for f in TRACKED_INT8_FILES}
    if after != before:
        raise AssertionError(f"int8 tools wrote a tracked file: {before} -> {after}")
    torch.cuda.empty_cache()
    log("int8_tools", f"all int8 tool checks passed in {time.perf_counter() - t0:.1f} s; "
        f"tracked files unchanged ({', '.join(TRACKED_INT8_FILES)}); launches of the tool runs "
        f"{total} | {card}")
    return total


# ---------------------------------------------------------------------- main


def main():
    t0 = time.perf_counter()
    card_name, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    from ffrnet_torch.api import FFRNet
    from ffrnet_torch.models.recnet import SS_KERNEL_CONFIG

    fused = FFRNet.random(seed=0, device=dev)
    models = {"fused": fused,
              "fused_fold_bn": fused.prepare(fold_bn=True),
              "ss_kernel": FFRNet.random(seed=0, cfg=SS_KERNEL_CONFIG, device=dev)}
    log("main", f"models ready: IR-SE50 + RecNet (C=512, 7x7), seed 0; configs "
        f"{ {k: (m.cfg.ss_impl, m.cfg.c4c_impl, m.cfg.channel_impl) for k, m in models.items()} }")
    errs = phase_kernels(fused, dev)
    errs.update(phase_warp_kernels(dev))
    main_counts = phase_main(models, dev)
    counts = phase_counts(main_counts, phase_ingest(fused, dev))
    times, bound, library = phase_times(models, dev, smi)
    phase_train(fused, dev, smi)
    phase_driver(dev, smi)
    for k, v in phase_serve(models, smi).items():
        counts[k] += v
    int8_counts, int8_time = phase_int8(dev, smi)
    for k, v in int8_counts.items():
        counts[k] += v
    for k, v in phase_export(models, dev, smi).items():
        counts[k] += v
    for k, v in phase_data_parallel(models, dev, smi).items():
        counts[k] += v
    for k, v in phase_model_axis(dev, smi).items():
        counts[k] += v
    for k, v in phase_extras(dev, smi).items():
        counts[k] += v
    for k, v in phase_int8_tools(dev, smi).items():
        counts[k] += v
    if counts["int8_conv"] == 0:
        raise AssertionError("int8_conv never launched on the int8 path")
    times["int8_conv"], bound["int8_conv"] = int8_time[:2], int8_time[2]
    # torch._int_mm computes the integer product of an im2col matrix (phase
    # 11 times it beside each shape), but not this function: no im2col, no
    # dequantizing epilogue, int32 out
    library["int8_conv"] = None
    record = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep, "launches": counts[k],
         "max_abs_err": errs[k], "ms": times[k][0], "plain_ms": times[k][1],
         "bound_ms": bound[k][0], "bound_by": "bytes" if bound[k][1] == "bytes" else "operations",
         "library_ms": library.get(k),
         "ok": True}
        for k, (src, rep) in KERNELS.items()]}
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    main()
