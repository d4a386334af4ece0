"""The `ffrnet` operator namespace: the port's inference kernels as PyTorch
operators, so that the dispatcher, not Python at trace time, picks the
kernel or its plain twin, and a traced graph (torch.export) holds the
operator itself.

Each operator has a CUDA implementation (checks, plan, one launch, the
wrapper's launch count), a CPU implementation (the plain twin), a fake one
(shapes and types only: no plan, no pointer, no host sync) and, where it
is differentiable, a gradient whose backward is the plain twin's VJP
(`_autograd.plain_vjp`). None of them is registered as a composite or as a
default for every device: such a kernel would let a trace decompose the
operator into its twin. A tensor on any other device finds no kernel and
raises.

    ffrnet::se_gating(Tensor x, Tensor w1, Tensor w2) -> Tensor
    ffrnet::channel_branch(Tensor flat, Tensor[] weights) -> Tensor
    ffrnet::self_similarity(Tensor x) -> (Tensor, Tensor)
    ffrnet::int8_conv(Tensor xq, Tensor wp, Tensor deq, Tensor? bias, int stride,
                      int padding, ScalarType out_dtype) -> Tensor

The registration is the low-level `torch.library.Library` define/impl:
the same operator as `torch.library.custom_op`, with a cheaper entry on
every call. The operators exist once `ffrnet_torch.ops.kernels` is
imported, which a saved program (`torch.export.load`) needs first.
"""

from __future__ import annotations

import torch

from ffrnet_torch.ops.kernels._autograd import save_inputs

LIB = torch.library.Library("ffrnet", "DEF")


def define(schema: str, *, cpu, cuda, fake, backward=None):
    """Define `ffrnet::<schema>` with its CPU, CUDA and fake implementations
    and, if `backward` is given, its gradient (`_autograd.save_inputs`
    keeps the inputs for it). Returns a call of the operator that raises
    ValueError for a first tensor on a device other than the CPU or a
    card (a meta tensor would otherwise reach the fake implementation)."""
    name = schema.split("(", 1)[0]
    qualname = f"ffrnet::{name}"
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(qualname, fake, lib=LIB)
    if backward is not None:
        torch.library.register_autograd(qualname, backward, setup_context=save_inputs,
                                        lib=LIB)
    op = getattr(torch.ops.ffrnet, name).default

    def call(first, *args):
        if first.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: unsupported device {first.device}")
        return op(first, *args)

    return call
