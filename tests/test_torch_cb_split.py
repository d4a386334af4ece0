"""Why the channel-branch kernel splits its tensor-core products, on the CPU.

The kernel (ffrnet_torch/csrc/channel_branch.cu) computes h W5^T and M X
with TF32 tensor-core products. Here TF32 is emulated (round to nearest at
13 dropped mantissa bits, ties away from zero, as `cvt.rna.tf32.f32`
does), each product of two TF32 values is exact in fp32, and the sums are
fp32. On the weights and input of
tests/test_torch_kernels.py::test_channel_branch_matches_pallas (C=512,
HW=49, N=2), against `channel_branch_plain` and the card's bound (1e-4,
1e-4):
  - 3xTF32 (x = hi + lo; lo*hi + hi*lo, then hi*hi) on both products is
    within the bound;
  - one TF32 pass is far outside it, so the card's tolerance catches a
    kernel that drops the split;
  - with bf16 X, which TF32 holds exactly, M X as P_lo X + P_hi X (two
    products) is within the bound of the plain version on that X.
"""

import numpy as np
import pytest
import torch

from ffrnet_torch.ops.kernels.channel_branch import _collapse, channel_branch_plain
from tests.test_torch_cuda import c4c_tree, tree_map

BOUND = dict(atol=1e-4, rtol=1e-4)  # the card's fp32 tolerance


def tf32(a):
    """`a` (float32) rounded to TF32: 10 mantissa bits, nearest, ties away
    from zero (an add on the magnitude's bits, then a mask)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def hi_lo(a):
    hi = tf32(a)
    return hi, tf32(a - hi)


def mm_1x(a, b):
    return tf32(a) @ tf32(b)


def mm_3x(a, b):
    (ah, al), (bh, bl) = hi_lo(a), hi_lo(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_2x_exact_b(a, b):
    """a b where b is exact in TF32: a_lo b + a_hi b."""
    assert torch.equal(tf32(b), b)
    ah, al = hi_lo(a)
    return al @ b + ah @ b


def branch(flat, weights, mm_logits, mm_out):
    """`channel_branch_plain` with its two large products taken by
    `mm_logits` (h W5^T) and `mm_out` (M X)."""
    w1f, w1s, b1, s0, wc1, bc1, s1, wc2, bc2, s2, w5, b5 = weights
    x = flat if flat.dtype == torch.float64 else flat.float()
    inv_r = 1.0 / torch.clamp_min(torch.sqrt(torch.sum(x * x, dim=2, keepdim=True)), 1e-12)
    ghat = x * inv_r
    h = x @ w1f.T + ghat @ torch.matmul(w1s, ghat).transpose(1, 2) + b1
    h = torch.where(h >= 0, h, s0[:, None] * h)
    h = h @ wc1.T + bc1
    h = torch.where(h >= 0, h, s1[:, None] * h)
    h = h @ wc2.T + bc2
    h = torch.where(h >= 0, h, s2[:, None] * h)
    m = torch.sigmoid(mm_logits(h, w5.T) + b5)
    return mm_out(m, x)


def excess(got, want, scale=1):
    """The largest error as a share of the bound (its atol times `scale`):
    at most 1 is within it."""
    lim = BOUND["atol"] * scale + BOUND["rtol"] * want.abs()
    return ((got.double() - want.double()).abs() / lim).max().item()


def inputs(biases):
    torch.set_num_threads(1)
    weights = _collapse(tree_map(c4c_tree(3, biases), torch.from_numpy))
    flat = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 512, 49))
                            .astype(np.float32))
    return flat, weights


@pytest.mark.parametrize("scheme", ["3xtf32", "1xtf32", "bf16_x_2xtf32"])
@pytest.mark.parametrize("biases", [True, False])
def test_tf32_split_against_the_bound(biases, scheme):
    flat, weights = inputs(biases)
    if scheme == "bf16_x_2xtf32":
        flat = flat.bfloat16().float()  # what the kernel reads of a bf16 map
        got = branch(flat, weights, mm_3x, mm_2x_exact_b)
    elif scheme == "3xtf32":
        got = branch(flat, weights, mm_3x, mm_3x)
    else:
        got = branch(flat, weights, mm_1x, mm_1x)
    want = channel_branch_plain(flat, weights)
    assert torch.isfinite(got).all()
    if scheme == "1xtf32":
        assert excess(got, want) > 10  # about 100x on these inputs
    else:
        assert excess(got, want) <= 1


@pytest.mark.parametrize("biases", [True, False])
def test_batch_x8_needs_the_atol_scaled(biases):
    """The card checks a batch scaled x8 with atol 8e-4: there the fp32
    plain version alone is 0.96-1.10 of the unscaled bound off an fp64
    evaluation, since the rounding of its 512-term sums grows with x, so
    any other order of those sums can cross it. 3xTF32 stays within the
    scaled bound of both."""
    flat, weights = inputs(biases)
    flat = 8 * flat
    plain = channel_branch_plain(flat, weights)
    exact = branch(flat.double(), [w.double() for w in weights], torch.matmul, torch.matmul)
    split = branch(flat, weights, mm_3x, mm_3x)
    assert excess(plain, exact) > 0.9
    assert excess(plain, exact, scale=8) <= 1
    assert excess(split, plain, scale=8) <= 1 and excess(split, exact, scale=8) <= 1


def test_tf32_rounding_is_nearest_ties_away():
    e = 2.0 ** -10  # one TF32 step at 1
    x = torch.tensor([1 + e / 2, -(1 + e / 2), 1 + e / 4, 1 + 3 * e / 4, 1 + e, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([1 + e, -(1 + e), 1.0, 1 + e, 1 + e, 3.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)


def test_hi_lo_split_is_exact_to_the_dropped_bits():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = hi_lo(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()
    # hi + lo holds x to 22 bits: what the dropped lo*lo term leaves
    assert ((hi.double() + lo.double() - x.double()).abs() <= x.abs().double() * 2.0 ** -21).all()
