"""Drive the PyTorch/H100 port's inference path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without a result line:

  1. device   the card's name and power limit (fails without a card)
  2. build    the three CUDA kernels from ffrnet_torch/csrc, nvcc for sm_90a
  3. kernels  each kernel vs its plain PyTorch version at the main path's
              shapes, N=64, fp32 (TF32 off) and bf16, with the tolerances
  4. main     FFRNet.random(seed=0) embed / verify / evaluate in both RecNet
              configurations (fused channel branch; self-similarity kernel),
              plus a BN-folded model; whole-path parity with the CPU
  5. counts   the launch counts of the main path's runs
  6. times    embed faces/s at N=256 (fp32, bf16) and each kernel's time
              beside its plain version and its bound, with CUDA events

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

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 SIMT FLOP/s;
# every kernel of this slice computes in fp32 whatever its storage type
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

KERNELS = {
    "se_gating": ("ffrnet_torch/csrc/se_gating.cu", "ffrnet_tpu/ops/pallas/se_gating.py:55"),
    "self_similarity": ("ffrnet_torch/csrc/self_similarity.cu",
                        "ffrnet_tpu/ops/pallas/self_similarity.py:67"),
    "channel_branch": ("ffrnet_torch/csrc/channel_branch.cu",
                       "ffrnet_tpu/ops/pallas/channel_branch.py:136"),
}
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
    from ffrnet_torch.ops.kernels.channel_branch import channel_branch, channel_branch_plain
    from ffrnet_torch.ops.kernels.se_gating import se_gating, se_gating_plain
    from ffrnet_torch.ops.kernels.self_similarity import (self_similarity_fused,
                                                          self_similarity_fused_plain)

    n = 64
    g = gen(10)
    errs = {k: 0.0 for k in KERNELS}
    for dname, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for h, c, _ in SE_STAGES:
            x = torch.randn(n, c, h, h, generator=g).to(dev, dt)
            w1 = (0.2 * torch.randn(c // 16, c, generator=g)).to(dev, dt)
            w2 = (0.2 * torch.randn(c, c // 16, generator=g)).to(dev, dt)
            tol = TOL.get((dname, "se_gating"), BF16_TOL)
            e = check_close(f"se_gating {dname} {tuple(x.shape)}", se_gating(x, w1, w2),
                            se_gating_plain(x, w1, w2), *tol)
            log("kernels", f"se_gating {dname} x{tuple(x.shape)} max_abs_err {e:.3e} "
                f"tol atol={tol[0]} rtol={tol[1]} (|x| <= {x.abs().max().item():.1f})")
            if dname == "fp32":
                errs["se_gating"] = max(errs["se_gating"], e)
        x = torch.randn(n, 512, 7, 7, generator=g).to(dev, dt)
        x[-1] = 0  # an all-zero map stays finite
        tol = TOL.get((dname, "self_similarity"), BF16_TOL)
        for which, got, want in zip(("ss_space", "ss_channel"), self_similarity_fused(x),
                                    self_similarity_fused_plain(x)):
            e = check_close(f"self_similarity {which} {dname}", got, want, *tol)
            log("kernels", f"self_similarity {which} {dname} x{tuple(x.shape)} (one zero "
                f"sample) max_abs_err {e:.3e} tol atol={tol[0]} rtol={tol[1]}")
            if dname == "fp32":
                errs["self_similarity"] = max(errs["self_similarity"], e)
        flat = torch.randn(n, 512, 49, generator=g).to(dev, dt)
        tol = TOL.get((dname, "channel_branch"), BF16_TOL)
        for biases in (True, False):
            w = c4c_weights(model, 11, biases, dev)
            want = channel_branch_plain(flat, w)
            e = check_close(f"channel_branch {dname} biases={biases}",
                            channel_branch(flat, w), want, *tol)
            log("kernels", f"channel_branch {dname} x{tuple(flat.shape)} biases={biases} "
                f"max_abs_err {e:.3e} tol atol={tol[0]} rtol={tol[1]} "
                f"(|out| <= {want.abs().max().item():.1f})")
            if dname == "fp32":
                errs["channel_branch"] = max(errs["channel_branch"], e)
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


def phase_counts(counts):
    total = {k: 0 for k in KERNELS}
    for name, (forwards, c) in counts.items():
        expected = {"se_gating": 24 * forwards,
                    "channel_branch": forwards if name.startswith("fused") else 0,
                    "self_similarity": forwards if name.startswith("ss_kernel") else 0}
        if c != expected:
            raise AssertionError(f"{name}: launch counts {c}, expected {expected} for "
                                 f"{forwards} forwards")
        log("counts", f"{name}: {forwards} encoder+RecNet forwards -> {c} "
            f"(24 se_gating per forward, its RecNet kernel once per forward)")
        for k in total:
            total[k] += c[k]
    missing = [k for k, v in total.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return total


# ------------------------------------------------------------------ phase 6


def bounds(n):
    """(bound_ms, bound_by) per kernel at batch n in fp32, from the bytes
    each must move (inputs read once, outputs written once) and the fp32
    operations it does."""
    b = 4
    se_bytes = se_ops = 0
    for h, c, units in SE_STAGES:
        r, hw = c // 16, h * h
        se_bytes += units * (2 * n * c * hw * b + 2 * c * r * b)
        se_ops += units * (2 * n * c * hw + 4 * n * c * r)
    c, hw = 512, 49
    ss_bytes = n * c * hw * b + n * (hw * hw + c * c) * b
    # both Grams are symmetric: a SYRK needs only their upper triangles
    ss_ops = 2 * n * (hw * (hw + 1) // 2 * c + c * (c + 1) // 2 * hw) + 2 * n * c * hw
    cb_bytes = 2 * n * c * hw * b + (32 * (hw + c) + 2 * 32 * 32 + c * 32 + 3 * c + 4 * 32 + c) * b
    cb_ops = n * (2 * 32 * c * hw + 4 * c * 32 * hw + 4 * c * 32 * 32 + 2 * c * c * 32
                  + 2 * c * c * hw)
    out = {}
    for k, (by, ops) in {"se_gating": (se_bytes, se_ops), "self_similarity": (ss_bytes, ss_ops),
                         "channel_branch": (cb_bytes, cb_ops)}.items():
        t_bytes, t_ops = by / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
        out[k] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def phase_times(models, dev, card):
    from ffrnet_torch.ops.kernels.channel_branch import channel_branch, channel_branch_plain
    from ffrnet_torch.ops.kernels.se_gating import se_gating, se_gating_plain
    from ffrnet_torch.ops.kernels.self_similarity import (self_similarity_fused,
                                                          self_similarity_fused_plain)

    n = 256
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
    runs = {"se_gating": (se_forward(se_gating), se_forward(se_gating_plain),
                          "24 gates of one IR-SE50 forward"),
            "self_similarity": (lambda: self_similarity_fused(x_ss),
                                lambda: self_similarity_fused_plain(x_ss), "(256,512,7,7)"),
            "channel_branch": (lambda: channel_branch(flat, w_cb),
                               lambda: channel_branch_plain(flat, w_cb), "(256,512,49)")}
    bound = bounds(n)
    times = {}
    for k, (kern, plain, what) in runs.items():
        # plain, kernel, kernel, plain: the two versions in turns
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
        times[k] = (min(k1, k2), min(p1, p2))
        log("times", f"{k} fp32 {what}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} "
            f"ms, bound {bound[k][0]:.4f} ms ({bound[k][1]}) | {card}")
    return times, bound


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
    counts = phase_counts(phase_main(models, dev))
    times, bound = phase_times(models, dev, smi)
    record = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep, "launches": counts[k],
         "max_abs_err": errs[k], "ms": times[k][0], "plain_ms": times[k][1],
         "bound_ms": bound[k][0], "bound_by": bound[k][1], "library_ms": None, "ok": True}
        for k, (src, rep) in KERNELS.items()]}
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    main()
