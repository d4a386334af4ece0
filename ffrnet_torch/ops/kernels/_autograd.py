"""Gradients of the port's kernels: the backward that each differentiable
operator registers (`_ops.define`) is the VJP of its plain twin,
recomputed in PyTorch ops from the saved inputs.

That is what the Pallas kernels' custom VJPs do (their backward is the VJP
of the XLA reference, e.g. ffrnet_tpu/ops/pallas/self_similarity.py:96-100):
neither package has a backward kernel.
"""

from __future__ import annotations

import torch


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


def save_inputs(ctx, inputs, output):
    """The `setup_context` of every differentiable operator: keep its tensor
    inputs (a list's in order) for `plain_vjp`; an output that nothing read
    gets a grad of None, not zeros."""
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(*(t for a in inputs
                            for t in (a if isinstance(a, (list, tuple)) else (a,))))
