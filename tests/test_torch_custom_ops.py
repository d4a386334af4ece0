"""The port's inference kernels as PyTorch operators (ffrnet_torch/ops/kernels/_ops.py).

On the CPU each operator runs its plain twin; `torch.library.opcheck`
holds its schema, its fake (shape-only) implementation, its autograd
registration and a dynamic-shape trace against that. A trace keeps the
operator as one node, and none of them has a composite kernel through
which a trace could fall back to the twin. Inputs are made with numpy
from a seed.
"""

import operator

import numpy as np
import pytest
import torch
from torch.library import opcheck

from ffrnet_torch.ops.kernels.channel_branch import _collapse, channel_branch
from ffrnet_torch.ops.kernels.int8_conv import int8_conv, pack_weight, to_nhwc
from ffrnet_torch.ops.kernels.se_gating import se_gating
from ffrnet_torch.ops.kernels.self_similarity import self_similarity_fused
from tests.test_torch_cuda import c4c_tree, tree_map

torch.set_num_threads(1)

OPS = ("se_gating", "channel_branch", "self_similarity", "int8_conv")


def _t(rng, shape, scale=1.0, grad=False):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)
                            ).requires_grad_(grad)


def _se_args(grad):
    rng = np.random.default_rng(0)
    return (_t(rng, (2, 64, 7, 7), grad=grad), _t(rng, (4, 64), 0.2, grad),
            _t(rng, (64, 4), 0.2, grad))


def _cb_args(grad):
    rng = np.random.default_rng(1)
    leaves = tree_map(c4c_tree(2, True, c=64, hw=49), lambda a: torch.from_numpy(a))
    weights = [w.detach().requires_grad_(grad) for w in _collapse(leaves)]
    return _t(rng, (2, 64, 49), grad=grad), weights


def _ss_args(grad):
    return (_t(np.random.default_rng(3), (2, 64, 4, 4), grad=grad),)


def _int8_args(bias):
    """One 3x3 site, 49 -> 49 channels on a 5x5 map, padded as the kernel
    takes them; N=2."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 49, 5, 5), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (49, 49, 3, 3), dtype=np.int8))
    deq = torch.from_numpy(rng.uniform(1e-4, 1e-3, 49).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(49).astype(np.float32)) if bias else None
    return to_nhwc(x), pack_weight(w), deq, b, 1, 1, torch.float32


CASES = {
    "se_gating": lambda grad: (torch.ops.ffrnet.se_gating.default, _se_args(grad)),
    "channel_branch": lambda grad: (torch.ops.ffrnet.channel_branch.default, _cb_args(grad)),
    "self_similarity": lambda grad: (torch.ops.ffrnet.self_similarity.default, _ss_args(grad)),
}


@pytest.mark.parametrize("grad", [True, False], ids=["grad", "no_grad"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_opcheck_differentiable(name, grad):
    op, args = CASES[name](grad)
    opcheck(op, args)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_opcheck_int8_conv(bias):
    opcheck(torch.ops.ffrnet.int8_conv.default, _int8_args(bias))


@pytest.mark.parametrize("name", OPS)
def test_no_composite_kernel(name):
    """A CPU and a CUDA kernel, and no kernel for every device: a
    composite one would let a trace decompose the operator into its twin."""
    qualname = f"ffrnet::{name}"
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(qualname, "CPU") and has(qualname, "CUDA")
    for key in ("CompositeImplicitAutograd", "CompositeExplicitAutograd",
                "CompositeExplicitAutogradNonFunctional"):
        assert not has(qualname, key), key


class _Wrappers(torch.nn.Module):
    """Every wrapper once, as the models call them."""

    def __init__(self, cb_weights, int8_rest):
        super().__init__()
        self.cb_weights, self.int8_rest = cb_weights, int8_rest

    def forward(self, x, w1, w2, flat, ss_x, xq):
        wp, deq, bias, stride, padding, out_dtype = self.int8_rest
        return (se_gating(x, w1, w2), channel_branch(flat, self.cb_weights),
                *self_similarity_fused(ss_x),
                int8_conv(xq, wp, deq, bias, stride=stride, padding=padding,
                          out_dtype=out_dtype))


def test_trace_holds_the_operators_not_the_twins():
    """torch.export of the four wrappers on CPU tensors, batch symbolic:
    each is one `ffrnet.*` node, and no ATen op of a twin (the mean and
    sigmoid of the SE gate, the products and norms of the Grams and the
    channel branch, the float64 im2col of int8_conv) is in the graph."""
    flat, weights = _cb_args(False)
    xq, *rest = _int8_args(True)
    args = (*_se_args(False), flat, *_ss_args(False), xq)
    batch = torch.export.Dim("b", min=1)
    program = torch.export.export(_Wrappers([w.detach() for w in weights], rest), args,
                                  dynamic_shapes=tuple(None if i in (1, 2) else {0: batch}
                                                       for i in range(len(args))),
                                  strict=False)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function" and n.target is not operator.getitem]
    assert sorted(targets) == sorted(f"ffrnet.{name}.default" for name in OPS), targets
    # one program serves another batch size, and matches the eager wrappers
    rng = np.random.default_rng(9)
    x3 = (_t(rng, (3, 64, 7, 7)), args[1], args[2], _t(rng, (3, 64, 49)),
          _t(rng, (3, 64, 4, 4)), torch.cat([xq, xq[:1]]))
    got = program.module()(*x3)
    want = _Wrappers([w.detach() for w in weights], rest)(*x3)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_other_devices_raise():
    x = torch.zeros(2, 64, 7, 7, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        se_gating(x, torch.zeros(4, 64, device="meta"), torch.zeros(64, 4, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        self_similarity_fused(x)


def test_int8_conv_checks_run_in_each_implementation():
    """The operator called directly, not through the wrapper, still refuses
    operands the kernel does not take; so does its fake implementation."""
    xq, wp, deq, bias, stride, padding, _ = _int8_args(True)
    with pytest.raises(TypeError, match="out_dtype"):
        torch.ops.ffrnet.int8_conv(xq, wp, deq, bias, stride, padding, torch.float16)
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    fake = [mode.from_tensor(t) for t in (xq[..., :49], wp[..., :49], deq)]
    with mode, pytest.raises(ValueError, match="Cp"):
        int8_conv(*fake, stride=1, padding=1)
