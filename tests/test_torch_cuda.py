"""CUDA kernels of the port vs their plain versions, on the card.

Runs on a machine with an NVIDIA GPU and nvcc; without a card every test
skips. It imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from ffrnet_torch.ops.align import ARCFACE_REF_PTS, cv2_transform
from ffrnet_torch.ops.kernels.channel_branch import (_collapse, channel_branch,
                                                     channel_branch_plain)
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


def c4c_tree(seed, biases):
    """A Conv4Channel tree as numpy: C=512, HW=49, with random biases or
    with every bias None."""
    rng = np.random.default_rng(seed)
    dims = [(512 + 49, 32), (32, 512), (512, 32), (32, 512), (512, 32), (32, 512)]
    tree = {}
    for i, (din, dout) in enumerate(dims):
        tree[f"lin{i}"] = {
            "w": (rng.standard_normal((dout, din)) * np.sqrt(2.0 / din)).astype(np.float32),
            "b": rng.normal(0, 0.1, dout).astype(np.float32) if biases else None}
    for i in range(3):
        tree[f"prelu{i}"] = {"slope": rng.uniform(0.1, 0.4, 512).astype(np.float32)}
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
    for got, want in zip(self_similarity_fused(x), self_similarity_fused_plain(x)):
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    for biases in (True, False):
        weights = tuple(t.to(cuda) for t in _collapse(
            tree_map(c4c_tree(5, biases), torch.from_numpy)))
        flat = x.reshape(4, 512, 49)
        # 512-term fp32 sums in another order
        tol = TOL[dtype] if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(channel_branch(flat, weights).float(),
                                   channel_branch_plain(flat, weights).float(), **tol)


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
