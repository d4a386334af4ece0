"""Gradients of the port's kernels: `torch.autograd.Function`s whose forward
is the kernel (or, for a CPU tensor, its plain twin) and whose backward is
the VJP of the plain twin, recomputed in PyTorch ops from the saved inputs.

That is what the Pallas kernels' custom VJPs do (their backward is the VJP
of the XLA reference, e.g. ffrnet_tpu/ops/pallas/self_similarity.py:96-100):
neither package has a backward kernel.
"""

from __future__ import annotations

import torch


class KernelFunction(torch.autograd.Function):
    """apply(fwd, plain, *tensors): forward `fwd(*tensors)`; backward the
    VJP of `plain` at the saved tensors. An output that nothing read gets a
    grad of None and adds nothing; only the inputs that need a gradient
    get one."""

    @staticmethod
    def forward(ctx, fwd, plain, *tensors):
        ctx.set_materialize_grads(False)
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return fwd(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + plain_vjp(ctx.plain, ctx.saved_tensors, grads,
                                        ctx.needs_input_grad[2:])


def plain_vjp(plain, inputs, grads, needs):
    """The VJP of `plain` at `inputs` for the output cotangents `grads` (None
    for an output nothing read): a tuple with one entry per input, None
    where `needs` is False."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs)]
        outs = plain(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
    wanted = [x for x, need in zip(xs, needs) if need]
    if not pairs or not wanted:
        return (None,) * len(inputs)
    got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                   allow_unused=True))
    return tuple(next(got) if need else None for need in needs)
