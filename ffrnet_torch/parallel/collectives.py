"""The collectives of the data and model axes: what XLA inserted into the
JAX package's pjit'd programs, written out.

  * `all_reduce_sum` carries gradients: its backward all-reduces the
    upstream gradient (each rank's output feeds every rank's loss), as
    SyncBatchNorm's does. A plain `dist.all_reduce` in the forward would
    give each rank only its own loss's gradient, with no error.
  * `average_gradients`: one coalesced all-reduce of the gradients per
    dtype, divided by the group size, so the update sees the gradient of
    the global batch's mean loss.
  * `broadcast_tensors`: rank 0's values to every rank, in place.
  * `average_tensor`: the mean of a tensor over the group (the step
    metrics, which are per-sample means of equal shards).
  * `copy_to_group`: the class-sharded head's input, the identity forward
    and a sum over the model group backward, so the feature's gradient
    gets every class shard's share (Megatron's "f").
  * `all_reduce_max`, `all_gather_rows`: the global max of the sharded
    softmax and argmax, and the class rows gathered for a pth save.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, differentiable."""
    return _AllReduceSum.apply(x, group)


def _by_dtype(tensors):
    out = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out.values()


def _coalesced(tensors, collective) -> None:
    """Run `collective` on one flat buffer per dtype and copy it back."""
    for ts in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


@torch.no_grad()
def average_gradients(params: Iterable[torch.Tensor], group) -> None:
    """Each gradient replaced by its mean over `group`. A gradient that is
    None (an output nothing read) is None on every rank alike and is
    skipped alike."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    n = dist.get_world_size(group)

    def mean(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(n)

    _coalesced(grads, mean)


@torch.no_grad()
def broadcast_tensors(tensors: Iterable[torch.Tensor], group) -> None:
    """Rank 0 of `group`'s values into every rank's tensors, in place."""
    src = dist.get_global_rank(group, 0)
    _coalesced(list(tensors), lambda flat: dist.broadcast(flat, src, group=group))


@torch.no_grad()
def average_tensor(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of `t` over `group` (a new tensor)."""
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out.div_(dist.get_world_size(group))


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """`x` as it is, its gradient summed over the ranks of `group` (None:
    `x` itself)."""
    return x if group is None else _CopyToGroup.apply(x, group)


@torch.no_grad()
def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `t` over `group` (a new tensor)."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


@torch.no_grad()
def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' `t` (equal shapes) concatenated along dim 0 in group rank
    order: the model group's class shards as the padded class axis."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.detach().contiguous(), group=group)
    return torch.cat(parts)
