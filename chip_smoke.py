"""Drive the PyTorch/H100 port's inference, ingest and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without a result line:

  1. device   the card's name and power limit (fails without a card)
  2. build    the four kernel libraries from ffrnet_torch/csrc, one nvcc
              each for sm_90a, all at once
  3. kernels  each kernel vs its plain PyTorch version at the main path's
              shapes, N=64, fp32 (TF32 off) and bf16, with the tolerances;
              se_gating and channel_branch also at N=1 and 3, with an
              all-zero sample (se_gating on every cluster size its plans
              take, channel_branch also with saturated sigmoids and a batch
              x8); self_similarity at N=256 (also x100) and on every C of
              64, 192, 512 by HW of 16, 49, 64 by N of 1, 3, 64, with a zero
              sample and a zero channel row, ss_channel exactly symmetric;
              the two warps on 250x250x3 noise, to 112x112 and 112x96
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

The last three lines are the kernels' JSON record, the card's name and
power limit as nvidia-smi gives them, and the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32 SIMT FLOP/s
# and TF32 tensor-core FLOP/s; every kernel computes in fp32 whatever its
# storage type, channel_branch's two large products as TF32 hi/lo splits
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

KERNELS = {
    "se_gating": ("ffrnet_torch/csrc/se_gating.cu", "ffrnet_tpu/ops/pallas/se_gating.py:55"),
    "self_similarity": ("ffrnet_torch/csrc/self_similarity.cu",
                        "ffrnet_tpu/ops/pallas/self_similarity.py:67"),
    "channel_branch": ("ffrnet_torch/csrc/channel_branch.cu",
                       "ffrnet_tpu/ops/pallas/channel_branch.py:136"),
    "warp_affine_full": ("ffrnet_torch/csrc/warp.cu", "ffrnet_tpu/ops/pallas/warp.py:88"),
    "warp_affine_band": ("ffrnet_torch/csrc/warp.cu", "ffrnet_tpu/ops/pallas/warp.py:182"),
}
WARPS = ("warp_affine_full", "warp_affine_band")
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
    torch.cuda.synchronize()
    return errs


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
                    "warp_affine_full": 0, "warp_affine_band": 0}
        if c != expected:
            raise AssertionError(f"{name}: launch counts {c}, expected {expected} for "
                                 f"{forwards} forwards")
        log("counts", f"{name}: {forwards} encoder+RecNet forwards -> {c} "
            f"(24 se_gating per forward, its RecNet kernel once per forward)")
        for k in total:
            total[k] += c[k]
    expected = {"se_gating": 48, "channel_branch": 2, "self_similarity": 0,
                "warp_affine_full": 1, "warp_affine_band": 1}
    if ingest != expected:
        raise AssertionError(f"ingest: launch counts {ingest}, expected {expected}")
    log("counts", f"ingest (fused): 2 guarded align calls + 2 forwards -> {ingest} (the band "
        f"kernel for the 64 faces, the full kernel for the extreme batch)")
    for k in total:
        total[k] += ingest[k]
    missing = [k for k, v in total.items() if v == 0]
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
                        "warp_affine_full": 0, "warp_affine_band": 0}
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
    record = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep, "launches": counts[k],
         "max_abs_err": errs[k], "ms": times[k][0], "plain_ms": times[k][1],
         "bound_ms": bound[k][0], "bound_by": bound[k][1], "library_ms": library.get(k),
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
