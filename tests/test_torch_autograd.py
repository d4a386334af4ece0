"""Gradients of the port's kernel wrappers vs the JAX kernels' custom VJPs.

On the CPU each wrapper is its `torch.autograd.Function` with the plain
forward in place of the kernel; its backward is the VJP of the plain twin,
as the Pallas kernels' backward is the VJP of their XLA reference
(ffrnet_tpu/ops/pallas/*.py). The JAX side runs its custom VJP (forward in
interpret mode). Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ffrnet_torch.ops.kernels.channel_branch import _collapse, channel_branch
from ffrnet_torch.ops.kernels.se_gating import se_gating, se_gating_plain
from ffrnet_torch.ops.kernels.self_similarity import (self_similarity_fused,
                                                      self_similarity_fused_plain)
from ffrnet_tpu.ops.pallas.channel_branch import channel_branch_pallas
from ffrnet_tpu.ops.pallas.se_gating import se_gating_pallas
from ffrnet_tpu.ops.pallas.self_similarity import self_similarity_pallas
from tests.test_torch_cuda import c4c_tree, tree_map

torch.set_num_threads(1)

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _nchw(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(TDT[dtype])


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _close(got, want, scale_tol):
    """|got - want| <= tol * max|want| (a gradient's error scales with its
    largest entries, not with each entry)."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= scale_tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_se_gating_grad_matches_custom_vjp(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 14, 14, 64)).astype(np.float32)
    w1 = (0.2 * rng.standard_normal((4, 64))).astype(np.float32)
    w2 = (0.2 * rng.standard_normal((64, 4))).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jd = JDT[dtype]
    _, vjp = jax.vjp(se_gating_pallas, jnp.asarray(x, jd), jnp.asarray(w1, jd),
                     jnp.asarray(w2, jd))
    dx, dw1, dw2 = vjp(jnp.asarray(g, jd))
    xt = _nchw(x, dtype).requires_grad_()
    w1t = torch.from_numpy(w1).to(TDT[dtype]).requires_grad_()
    w2t = torch.from_numpy(w2).to(TDT[dtype]).requires_grad_()
    y = se_gating(xt, w1t, w2t)
    y.backward(_nchw(g, dtype))
    # fp32: reassociation (the JAX reference pools and gates in x's type,
    # the plain twin in fp32); bf16: the same at 8 mantissa bits, where the
    # weights' gradients sum 392 terms per sample
    tol = 1e-5 if dtype == "float32" else 3e-2
    _close(_nhwc(xt.grad), dx, tol)
    _close(w1t.grad.float().numpy(), dw1, tol)
    _close(w2t.grad.float().numpy(), dw2, tol)


@pytest.mark.parametrize("read", ["both", "ss_space_only"])
def test_self_similarity_grad_matches_custom_vjp(read):
    """Both Grams read, or only ss_space (as the loss reads feat_space's):
    the unread output's grad is None in the port and zeros in JAX."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 7, 512)).astype(np.float32)
    g_space = rng.standard_normal((2, 49, 49)).astype(np.float32)
    g_chan = rng.standard_normal((2, 512, 512)).astype(np.float32)
    if read == "ss_space_only":
        g_chan[:] = 0
    _, vjp = jax.vjp(self_similarity_pallas, jnp.asarray(x))
    (dx,) = vjp((jnp.asarray(g_space), jnp.asarray(g_chan)))
    xt = _nchw(x).requires_grad_()
    ss_space, ss_channel = self_similarity_fused(xt)
    loss = (ss_space * torch.from_numpy(g_space)).sum()
    if read == "both":
        loss = loss + (ss_channel * torch.from_numpy(g_chan)).sum()
    loss.backward()
    # fp32: the VJP of normalize-then-Gram (JAX) vs of Gram-then-scale
    # (the twin), equal up to reassociation
    _close(_nhwc(xt.grad), dx, 1e-5)


@pytest.mark.parametrize("read", [(True, True), (True, False), (False, True)])
def test_self_similarity_backward_is_the_plain_vjp(read):
    """The Function's backward recomputes the twin (or the half of it whose
    Gram was read) from the saved input, so it equals autograd through the
    twin to the bit."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 64, 4, 4)).astype(np.float32)).requires_grad_()
    g = [torch.from_numpy(np.random.default_rng(s).standard_normal(shape).astype(np.float32))
         for s, shape in ((3, (3, 16, 16)), (4, (3, 64, 64)))]
    grads = []
    for fn in (self_similarity_fused, self_similarity_fused_plain):
        x.grad = None
        sum(((o * gg).sum() for o, gg, r in zip(fn(x), g, read) if r)).backward()
        grads.append(x.grad.clone())
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def test_se_gating_backward_is_the_plain_vjp():
    rng = np.random.default_rng(5)
    ts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_()
          for s in ((2, 64, 7, 7), (4, 64), (64, 4))]
    got = []
    for fn in (se_gating, se_gating_plain):
        for t in ts:
            t.grad = None
        fn(*ts).square().sum().backward()
        got.append([t.grad.clone() for t in ts])
    for a, b in zip(*got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("biases", [True, False])
def test_channel_branch_grad_matches_custom_vjp(biases):
    """Gradients to flat and to every Conv4Channel weight: the port's reach
    the weights through `_collapse` (PyTorch ops), JAX's through the VJP
    of its factored reference."""
    tree = c4c_tree(6, biases)
    rng = np.random.default_rng(7)
    flat = rng.standard_normal((2, 512, 49)).astype(np.float32)
    g = rng.standard_normal((2, 49, 512)).astype(np.float32)  # JAX's (N, HW, C)
    _, vjp = jax.vjp(channel_branch_pallas, jnp.asarray(flat), tree_map(tree, jnp.asarray))
    dflat, dtree = vjp(jnp.asarray(g))
    leaves = tree_map(tree, lambda a: torch.from_numpy(a).requires_grad_())
    flat_t = torch.from_numpy(flat).requires_grad_()
    out = channel_branch(flat_t, _collapse(leaves))
    out.backward(torch.from_numpy(g.transpose(0, 2, 1).copy()))
    # fp32, 512-term sums in another order through the collapsed affines
    _close(flat_t.grad.numpy(), dflat, 1e-5)
    for k, d in leaves.items():
        for kk, t in d.items():
            if t is None:
                assert dtree[k][kk] is None
                continue
            _close(t.grad.numpy(), dtree[k][kk], 1e-5)
