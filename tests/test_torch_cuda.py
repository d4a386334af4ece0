"""CUDA kernels of the port vs their plain versions, on the card.

Runs on a machine with an NVIDIA GPU and nvcc; without a card every test
skips. It imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from ffrnet_torch.ops.align import ARCFACE_REF_PTS, cv2_transform
from ffrnet_torch.ops.kernels.channel_branch import (_collapse, channel_branch,
                                                     channel_branch_plain)
from ffrnet_torch.ops.kernels.int8_conv import (int8_conv, int8_conv_plain, pack_weight,
                                                to_nhwc)
from ffrnet_torch.ops.kernels.se_gating import _se_plan, se_gating, se_gating_plain
from ffrnet_torch.ops.kernels.self_similarity import (
    self_similarity_fused, self_similarity_fused_plain)
from ffrnet_torch.ops.kernels.warp import (warp_affine_band, warp_affine_band_plain,
                                           warp_affine_full, warp_affine_full_plain)

# fp32: reassociation of short sums; bf16: one rounding of the output at
# 8 mantissa bits (2^-8 ~ 4e-3 relative), with room for a flipped rounding
# of the gate
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def c4c_tree(seed, biases, c=512, hw=49):
    """A Conv4Channel tree as numpy (C=512, HW=49 unless given), with
    random biases or with every bias None."""
    rng = np.random.default_rng(seed)
    dims = [(c + hw, 32), (32, c), (c, 32), (32, c), (c, 32), (32, c)]
    tree = {}
    for i, (din, dout) in enumerate(dims):
        tree[f"lin{i}"] = {
            "w": (rng.standard_normal((dout, din)) * np.sqrt(2.0 / din)).astype(np.float32),
            "b": rng.normal(0, 0.1, dout).astype(np.float32) if biases else None}
    for i in range(3):
        tree[f"prelu{i}"] = {"slope": rng.uniform(0.1, 0.4, c).astype(np.float32)}
    return tree


def tree_map(tree, fn):
    return {k: {kk: (None if v is None else fn(v)) for kk, v in d.items()}
            for k, d in tree.items()}



@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(cuda, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    dt = TDT[dtype]
    clusters = set()
    for (h, c) in ((56, 64), (28, 128), (14, 256), (7, 512)):
        w1 = (0.2 * torch.randn(c // 16, c, generator=g)).to(cuda, dt)
        w2 = (0.2 * torch.randn(c, c // 16, generator=g)).to(cuda, dt)
        clusters.add(_se_plan(c, h * h, c // 16, TDT[dtype].itemsize)[0])
        for n in (1, 3, 4):
            x = torch.randn(n, c, h, h, generator=g).to(cuda, dt)
            if n == 3:
                x[1] = 0  # an all-zero map: its gate is sigmoid(0), finite
            got = se_gating(x, w1, w2)
            assert torch.isfinite(got).all()
            torch.testing.assert_close(got.float(), se_gating_plain(x, w1, w2).float(),
                                       **TOL[dtype])
    # clusters of 8, 4, 2 and 1 CTAs
    assert clusters == {8, 4, 2, 1}
    x = torch.randn(4, 512, 7, 7, generator=g).to(cuda, dt)
    x[3] = 0
    check_self_similarity(x, dtype)
    check_self_similarity_edges(cuda, dtype)
    flat = x.reshape(4, 512, 49)
    for biases in (True, False):
        weights = cb_weights(5, biases, 512, 49, cuda)
        check_channel_branch(flat, weights, dtype)
    check_channel_branch_edges(cuda, dtype)


def check_self_similarity(x, dtype):
    """Kernel vs plain twin within TOL, in x's type and shapes; both Grams
    exactly symmetric (each off-diagonal tile of ss_channel is stored twice
    from one value, and both halves of a diagonal tile come from the same
    products summed in the same order)."""
    n, c, h, w = x.shape
    got = self_similarity_fused(x)
    for g, want, shape in zip(got, self_similarity_fused_plain(x),
                              ((n, h * w, h * w), (n, c, c))):
        assert g.dtype == x.dtype and tuple(g.shape) == shape
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), want.float(), **TOL[dtype])
        assert torch.equal(g, g.transpose(1, 2))


def check_self_similarity_edges(cuda, dtype):
    """Every (N, C, HW) of N 1, 3, 64 by C 64, 192, 512 by HW 16, 49, 64.
    Sample 0 has a zero channel row (its norm takes the 1e-12 clamp; its
    row and column of ss_channel are 0); sample 1, where there is one, is
    all zero; and the main path's shape again with the inputs x100."""
    g = torch.Generator().manual_seed(4)
    dt = TDT[dtype]
    for c in (64, 192, 512):
        for h in (4, 7, 8):
            for n in (1, 3, 64):
                x = torch.randn(n, c, h, h, generator=g)
                x[0, 5] = 0
                if n > 1:
                    x[1] = 0
                x = x.to(cuda, dt)
                check_self_similarity(x, dtype)
                ss_channel = self_similarity_fused(x)[1]
                assert (ss_channel[0, 5] == 0).all() and (ss_channel[0, :, 5] == 0).all()
                if n > 1:
                    assert (ss_channel[1] == 0).all()
    check_self_similarity((100 * torch.randn(3, 512, 7, 7, generator=g)).to(cuda, dt), dtype)


def cb_weights(seed, biases, c, hw, device):
    return tuple(t.to(device) for t in _collapse(
        tree_map(c4c_tree(seed, biases, c, hw), torch.from_numpy)))


def check_channel_branch(flat, weights, dtype, scale=1):
    """Kernel vs plain twin: fp32 within 1e-4 (512-term sums in another
    order, 3xTF32 products), its atol scaled with the input (`scale`);
    bf16 within one rounding of the output. A zero sample gives zeros."""
    tol = TOL[dtype] if dtype == "bfloat16" else dict(atol=1e-4 * scale, rtol=1e-4)
    got = channel_branch(flat, weights)
    assert got.dtype == flat.dtype and got.shape == flat.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), channel_branch_plain(flat, weights).float(), **tol)
    zero = (flat == 0).flatten(1).all(1)
    assert (got[zero] == 0).all()


def check_channel_branch_edges(cuda, dtype):
    """N = 1, 3 (one zero sample) and 64 at C=512, HW=49, with and without
    biases; saturated sigmoids (W5 and b5 x8); a batch x8; and other
    plans: C=128 (a cluster of 2), C=192 (one CTA, three row blocks) with
    HW=56 (every tile column used) and HW=20."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(3)
    dt = TDT[dtype]
    for biases in (True, False):
        w = cb_weights(7, biases, 512, 49, cuda)
        for n in (1, 3, 64):
            flat = torch.randn(n, 512, 49, generator=g)
            if n == 3:
                flat[1] = 0
            check_channel_branch(flat.to(cuda, dt), w, dtype)
        flat = torch.randn(3, 512, 49, generator=g).to(cuda, dt)
        saturated = w[:10] + (8 * w[10], 8 * w[11])
        check_channel_branch(flat, saturated, dtype)
        # the fp32 twin alone is 0.96-1.1e-4 off an fp64 evaluation here
        # (tests/test_torch_cb_split.py): the sums' rounding grows with x
        check_channel_branch(8 * flat, w, dtype, scale=8)
    for n, c, hw in ((2, 128, 20), (3, 192, 56)):
        flat = torch.randn(n, c, hw, generator=g)
        flat[-1] = 0
        check_channel_branch(flat.to(cuda, dt), cb_weights(8, True, c, hw, cuda), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_warps_match_plain(cuda, dtype):
    """Kernel and twin round the same fp32 operations: equal to the bit
    (the tolerance allows one output step of the type on 0-255 pixels)."""
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(rng.uniform(0, 255, (3, 250, 250, 3)).astype(np.float32))
    imgs = imgs.to(cuda, TDT[dtype])
    lmk = (ARCFACE_REF_PTS[None] * 2.1 + rng.normal(0, 2, (3, 5, 2)) + 15).astype(np.float32)
    ref = torch.from_numpy(np.broadcast_to(ARCFACE_REF_PTS, lmk.shape).copy())
    mats = cv2_transform(torch.from_numpy(lmk), ref).to(cuda)
    tol = dict(atol=1e-4, rtol=0) if dtype == "float32" else dict(atol=1.0, rtol=0)
    for out_hw in ((112, 112), (112, 96)):
        for cd in (torch.float32, torch.bfloat16):
            torch.testing.assert_close(
                warp_affine_full(imgs, mats, out_hw=out_hw, compute_dtype=cd).float(),
                warp_affine_full_plain(imgs, mats, out_hw=out_hw, compute_dtype=cd).float(),
                **tol)
        for crop_w in (64, 96, 224):
            got = warp_affine_band(imgs, mats, out_hw=out_hw, crop_w=crop_w)
            assert got.dtype == imgs.dtype
            torch.testing.assert_close(
                got.float(),
                warp_affine_band_plain(imgs, mats, out_hw=out_hw, crop_w=crop_w).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_gradients_match_plain(cuda, dtype):
    """Each wrapper's Function (kernel forward, the twin's VJP backward) vs
    autograd through the plain twin: the forward within TOL, the gradients
    to the bit, since the backward recomputes the twin from the same
    inputs."""
    g = torch.Generator().manual_seed(6)
    dt = TDT[dtype]
    weights = cb_weights(9, True, 512, 49, cuda)
    # channel_branch's fp32 forward: 512-term sums, 3xTF32 (check_channel_branch)
    cb_tol = TOL[dtype] if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)
    cases = [((torch.randn(3, 512, 7, 7, generator=g).to(cuda, dt),),
              self_similarity_fused, self_similarity_fused_plain, TOL[dtype]),
             ((torch.randn(3, 512, 49, generator=g).to(cuda, dt), *weights),
              lambda f, *w: channel_branch(f, w), lambda f, *w: channel_branch_plain(f, w),
              cb_tol)]
    for h, c in ((56, 64), (28, 128), (14, 256), (7, 512)):
        cases.append(((torch.randn(3, c, h, h, generator=g).to(cuda, dt),
                       (0.2 * torch.randn(c // 16, c, generator=g)).to(cuda, dt),
                       (0.2 * torch.randn(c, c // 16, generator=g)).to(cuda, dt)),
                      se_gating, se_gating_plain, TOL[dtype]))
    for args, kern, plain, tol in cases:
        outs, grads = [], []
        for fn in (kern, plain):
            leaves = [a.detach().clone().requires_grad_() for a in args]
            out = fn(*leaves)
            out = out if isinstance(out, tuple) else (out,)
            cot = [torch.randn(o.shape, generator=torch.Generator().manual_seed(7)).to(cuda, o.dtype)
                   for o in out]
            grads.append(torch.autograd.grad(out, leaves, cot))
            outs.append(out)
        for a, b in zip(*outs):
            torch.testing.assert_close(a.float(), b.float(), **tol)
        for a, b in zip(*grads):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_short_training_run(cuda):
    """Five Adam steps of train_step (N=4, 16 classes, fp32) in both RecNet
    configurations on the card: finite losses that fall on a repeated
    batch, 24 SE launches per step, and 7 self-similarity launches per step
    in SS_KERNEL_CONFIG (0 in the default)."""
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.models.recnet import SS_KERNEL_CONFIG, RecNetConfig
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
    from ffrnet_torch.training.trainer import TrainerConfig, create_train_state, train_step

    enc = build_backbone(generator=torch.Generator().manual_seed(0), device=cuda)
    g = torch.Generator().manual_seed(8)
    batch = {"img_non": torch.randint(0, 256, (4, 112, 112, 3), generator=g, dtype=torch.uint8),
             "img_ocl": torch.randint(0, 256, (4, 112, 112, 3), generator=g, dtype=torch.uint8),
             "label": torch.tensor([0, 3, 7, 15])}
    for rec, ss in ((RecNetConfig(num_classes=16), 0),
                    (dataclasses.replace(SS_KERNEL_CONFIG, num_classes=16), 7)):
        cfg = TrainerConfig(optimizer="adam", lr=1e-3, recnet=rec)
        state = create_train_state(cfg, device=cuda)
        losses = []
        for _ in range(5):
            reset_launch_counts()
            state, m = train_step(enc, state, batch, cfg=cfg)
            torch.cuda.synchronize()
            c = launch_counts()
            assert (c["se_gating"], c["self_similarity"], c["channel_branch"]) == (24, ss, 0)
            losses.append(float(m["TotalLoss"]))
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        assert state.step == 5


@pytest.mark.cuda
def test_cuda_service_matches_direct_embed(cuda):
    """The micro-batching service on the card (fused fp32, TF32 off): 12
    uint8 and float groups from 4 threads, each result against a direct
    embed of the same faces (cuDNN may plan each batch size differently:
    1e-4 abs + rel), and the kernels launched only by the collector: 24
    se_gating and 1 channel_branch per dispatched batch."""
    import threading

    from ffrnet_torch.api import FFRNet
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
    from ffrnet_torch.serving import EmbeddingService

    model = FFRNet.random(seed=0, device=cuda)
    faces = np.random.default_rng(9).integers(0, 256, (24, 112, 112, 3), dtype=np.uint8)
    want = [t.cpu() for t in model.embed(faces)]
    groups = [(2 * i, 2 * i + 2) for i in range(12)]
    with EmbeddingService(model, max_batch=16, max_delay_s=0.005) as svc:
        svc.warmup()
        reset_launch_counts()
        outs = [None] * len(groups)

        def client(k):
            for j in range(k, len(groups), 4):
                a, b = groups[j]
                x = faces[a:b] if j % 2 else (faces[a:b] / 255.0 - 0.5) / 0.5
                outs[j] = [t.cpu() for t in svc.submit(x).result(timeout=120)]

        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        torch.cuda.synchronize()
        counts = launch_counts()
    assert not any(t.is_alive() for t in threads)
    for (a, b), (raw, rect) in zip(groups, outs):
        torch.testing.assert_close(raw, want[0][a:b], atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(rect, want[1][a:b], atol=1e-4, rtol=1e-4)
    n = svc.stats.batches
    assert svc.stats.faces == 24 and svc.stats.errors == 0 and n >= 2
    assert (counts["se_gating"], counts["channel_branch"], counts["self_similarity"]) == (24 * n, n, 0)


# (Cin, Cout, input H = W, window, stride, padding) of every int8 site shape
# of IR-SE50 (112x112 input) and of RecNet (7x7 maps, reflect-padded to 9x9
# outside the conv); Cin 0 is the encoder's output Linear (K = 25088)
INT8_SITES = [(64, 64, 112, 3, 1, 1), (64, 64, 112, 3, 2, 1), (64, 64, 56, 3, 1, 1),
              (64, 128, 56, 3, 1, 1), (128, 128, 56, 3, 2, 1), (64, 128, 56, 1, 2, 0),
              (128, 128, 28, 3, 1, 1), (128, 256, 28, 3, 1, 1), (256, 256, 28, 3, 2, 1),
              (128, 256, 28, 1, 2, 0), (256, 256, 14, 3, 1, 1), (256, 512, 14, 3, 1, 1),
              (512, 512, 14, 3, 2, 1), (256, 512, 14, 1, 2, 0), (512, 512, 7, 3, 1, 1),
              (0, 512, 1, 1, 1, 0),
              (561, 256, 9, 3, 1, 0), (256, 256, 9, 3, 1, 0), (256, 128, 9, 3, 1, 0),
              (128, 128, 9, 3, 1, 0), (128, 49, 9, 3, 1, 0), (49, 49, 9, 3, 1, 0),
              (1024, 512, 9, 3, 1, 0), (512, 512, 9, 3, 1, 0), (1536, 512, 9, 3, 1, 0)]


def int8_operands(site, n, g, device, fill=None):
    """Random int8 operands of one site shape, packed as the kernel takes
    them, with deq and a bias; `fill` sets every activation and weight to
    that value (0: a zero map; 127: the accumulator's largest magnitude)."""
    cin, cout, h, k, _, _ = site
    shape = (n, 25088) if cin == 0 else (n, cin, h, h)
    wshape = (cout, 25088) if cin == 0 else (cout, cin, k, k)
    x = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, wshape, generator=g, dtype=torch.int8)
    if fill is not None:
        x.fill_(fill)
        w.fill_(fill)
    deq = torch.rand(cout, generator=g) * 1e-4
    bias = torch.randn(cout, generator=g)
    return (to_nhwc(x.to(device)), pack_weight(w.to(device)), deq.to(device), bias.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_cuda_int8_conv_matches_plain(cuda, out):
    """int8_conv vs its twin at every int8 site shape, N 1, 2 and 3 (K split
    over a cluster at N 1 and 2, persistent CTAs at larger N), with and
    without bias, and the Linear and the 14x14 256->256 site at N 256: the
    same integer product and the same two fp32 roundings, so equal to the
    bit; also a zero map, operands at 127 everywhere (the largest
    accumulator, 127^2 K) and a misaligned input view."""
    g = torch.Generator().manual_seed(11)
    dt = TDT[out]
    cases = [(site, n) for site in INT8_SITES for n in (1, 2, 3)]
    for site, n in cases + [(INT8_SITES[15], 256), (INT8_SITES[10], 256)]:
        stride, pad = site[4], site[5]
        xq, wp, deq, bias = int8_operands(site, n, g, cuda)
        for b in (bias, None):
            got = int8_conv(xq, wp, deq, b, stride=stride, padding=pad, out_dtype=dt)
            want = int8_conv_plain(xq, wp, deq, b, stride=stride, padding=pad, out_dtype=dt)
            assert got.shape == want.shape and got.dtype == dt
            assert torch.equal(got, want), (site, n)
    for site in (INT8_SITES[0], INT8_SITES[15], INT8_SITES[16], INT8_SITES[21]):
        for fill in (0, 127):
            xq, wp, deq, bias = int8_operands(site, 3, g, cuda, fill=fill)
            got = int8_conv(xq, wp, deq, bias, stride=site[4], padding=site[5], out_dtype=dt)
            assert torch.equal(got, int8_conv_plain(xq, wp, deq, bias, stride=site[4],
                                                    padding=site[5], out_dtype=dt))
    xq, wp, deq, bias = int8_operands(INT8_SITES[14], 2, g, cuda)
    buf = torch.zeros(xq.numel() + 8, dtype=torch.int8, device=cuda)
    view = buf[8:].view(xq.shape)  # 8 bytes off a 16-byte boundary
    view.copy_(xq)
    assert torch.equal(int8_conv(view, wp, deq, bias, stride=1, padding=1, out_dtype=dt),
                       int8_conv_plain(xq, wp, deq, bias, stride=1, padding=1, out_dtype=dt))


@pytest.mark.cuda
def test_cuda_int8_model_matches_cpu(cuda):
    """The same int8 model (fused, BN folded, 'all', fp32, calibrated) on
    the card and on the CPU: int8 levels can flip where cuDNN's float
    convolutions round otherwise than the CPU's, so rows are held by cosine;
    launches exact (52 int8_conv per encoder forward, 15 per RecNet)."""
    from ffrnet_torch.api import FFRNet
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts

    faces = np.random.default_rng(12).integers(0, 256, (4, 112, 112, 3), dtype=np.uint8)
    base = FFRNet.random(seed=0, device=cuda).prepare(fold_bn=True, quantize_int8="all")
    model = base.calibrate_int8([faces[:2]])
    cpu = FFRNet(model.encoder, model.recnet, model.cfg, "cpu").prepare()
    reset_launch_counts()
    card = model.embed(faces)
    torch.cuda.synchronize()
    c = launch_counts()
    assert (c["int8_conv"], c["se_gating"], c["channel_branch"]) == (52 + 15, 24, 1)
    for a, b in zip(card, cpu.embed(faces)):
        cos = torch.nn.functional.cosine_similarity(a.cpu(), b, dim=1)
        assert (cos > 0.999).all(), cos



@pytest.mark.cuda
def test_cuda_exported_program_launches_the_kernels(cuda, tmp_path):
    """export_embed of the fused fp32 model on the card, saved and loaded:
    at N=1 and 5 the loaded program launches 24 se_gating and 1
    channel_branch per call and matches embed (the JAX export test's
    bound, 1e-4 abs + rel)."""
    from ffrnet_torch.api import FFRNet
    from ffrnet_torch.ops.kernels import launch_counts, reset_launch_counts
    from ffrnet_torch.tools.export_model import export_embed

    model = FFRNet.random(seed=0, device=cuda)
    path = tmp_path / "ffrnet.pt2"
    torch.export.save(export_embed(model), str(path))
    run = torch.export.load(str(path)).module()
    faces = np.random.default_rng(13).uniform(-1, 1, (5, 112, 112, 3)).astype(np.float32)
    for n in (1, 5):
        x = torch.from_numpy(faces[:n]).to(cuda)
        want = model.embed(x)
        reset_launch_counts()
        with torch.inference_mode():
            got = run(x)
        torch.cuda.synchronize()
        c = launch_counts()
        assert (c["se_gating"], c["channel_branch"], c["self_similarity"]) == (24, 1, 0)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
