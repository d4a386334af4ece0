"""CUDA kernels of the port vs their plain versions, on the card.

Runs on a machine with an NVIDIA GPU and nvcc; without a card every test
skips. It imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from ffrnet_torch.ops.kernels.channel_branch import (_collapse, channel_branch,
                                                     channel_branch_plain)
from ffrnet_torch.ops.kernels.se_gating import se_gating, se_gating_plain
from ffrnet_torch.ops.kernels.self_similarity import (
    self_similarity_fused, self_similarity_fused_plain)

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
    for (h, c) in ((56, 64), (28, 128), (14, 256), (7, 512)):
        x = torch.randn(4, c, h, h, generator=g).to(cuda, dt)
        w1 = (0.2 * torch.randn(c // 16, c, generator=g)).to(cuda, dt)
        w2 = (0.2 * torch.randn(c, c // 16, generator=g)).to(cuda, dt)
        torch.testing.assert_close(se_gating(x, w1, w2).float(),
                                   se_gating_plain(x, w1, w2).float(), **TOL[dtype])
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
