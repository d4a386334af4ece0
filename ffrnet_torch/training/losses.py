"""The four-part FFR-Net training objective (ffrnet_tpu/training/losses.py).

  0. self-similarity: MSE between the frozen clean feature map's ss_space /
     ss_channel Grams and those of the rectified spatial / channel maps of
     BOTH branches, averaged
  1. triplet (cosine, margin 0.1): anchor = rectified masked embedding,
     pos = frozen clean embedding, neg = frozen masked embedding
  2. identity: MSE of both rectified embeddings against the frozen clean
     embedding
  3. classifier: CE on the CosFace logits of both branches; the clean term
     is divided by (1e-8 + loss_weight[3]), so that its weight cancels in
     the weighted sum (the reference's quirk, kept by default;
     `faithful_ce_weight=False` drops it)

Maps are NCHW (the JAX package's are NHWC). Every reduction is a mean and
is taken in fp32, whatever the forward's type.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ffrnet_torch.ops.nn import l2_normalize
from ffrnet_torch.ops.similarity import cosine_sim, self_similarity


def mse(a, b):
    return torch.mean(torch.square(a.float() - b.float()))


def cross_entropy(logits, labels, *, offset: int = 0, group=None):
    """Mean softmax cross-entropy over the batch, in fp32. With a model
    group, `logits` are this rank's class shard, the classes [offset,
    offset + logits.shape[1]), and the softmax runs over the shards of every
    rank of `group` (`_ShardedCrossEntropy`)."""
    logits = logits.float()
    if group is not None:
        return torch.mean(_ShardedCrossEntropy.apply(logits, labels.long(), offset, group))
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, 1, labels[:, None].long())[:, 0]
    return torch.mean(logz - true_logit)


def _own(labels, offset, rows):
    """(column of each label in the shard [offset, offset + rows), clamped;
    whether the shard holds it)."""
    local = labels - offset
    own = (local >= 0) & (local < rows)
    return local.clamp(0, rows - 1)[:, None], own


class _ShardedCrossEntropy(torch.autograd.Function):
    """Per-sample cross-entropy over class-sharded logits (N, R): the global
    max by one all-reduce, then sum(exp(x - max)) and the target logit (its
    owner's; 0 elsewhere) summed in a second. The backward is local:
    softmax_local - onehot_local."""

    @staticmethod
    def forward(ctx, logits, labels, offset, group):
        from ffrnet_torch.parallel.collectives import all_reduce_max

        gmax = all_reduce_max(logits.amax(dim=1), group)
        e = torch.exp(logits - gmax[:, None])
        idx, own = _own(labels, offset, logits.shape[1])
        target = torch.where(own, logits.gather(1, idx)[:, 0], torch.zeros_like(gmax))
        sums = torch.stack([e.sum(dim=1), target])
        torch.distributed.all_reduce(sums, group=group)
        ctx.save_for_backward(e / sums[0][:, None], idx, own)
        return torch.log(sums[0]) + gmax - sums[1]

    @staticmethod
    def backward(ctx, grad):
        p, idx, own = ctx.saved_tensors
        g = p.scatter_add(1, idx, -own[:, None].to(p.dtype))
        return g * grad[:, None], None, None, None


@torch.no_grad()
def argmax_classes(x, *, offset: int = 0, group=None):
    """argmax over the class axis of x (N, R), the first index of a tie as in
    torch.argmax and jnp.argmax; with a model group, over every rank's shard
    (x holds the classes [offset, offset + R)): each shard's max and first
    index, then the global max by one all-reduce and the lowest global index
    that reaches it by another."""
    idx = x.argmax(dim=1)
    if group is None:
        return idx
    from ffrnet_torch.parallel.collectives import all_reduce_max

    best = x.gather(1, idx[:, None])[:, 0]
    top = all_reduce_max(best, group)
    cand = torch.where(best == top, idx + offset, torch.full_like(idx, torch.iinfo(idx.dtype).max))
    torch.distributed.all_reduce(cand, op=torch.distributed.ReduceOp.MIN, group=group)
    return cand


def gram_mse_factored(a, b, *, eps: float = 1e-12):
    """mse(cosine Gram of a, cosine Gram of b) for row sets a, b (N, R, D)
    without the (N, R, R) Grams: with row-normalized A, B,
    ||A A^T - B B^T||_F^2 = ||A^T A||_F^2 - 2 ||A^T B||_F^2 + ||B^T B||_F^2,
    three (D, D) products. Equal up to reassociation; in fp32."""
    a = l2_normalize(a.float(), axis=2, eps=eps)
    b = l2_normalize(b.float(), axis=2, eps=eps)
    n, r, _ = a.shape
    aa = a.transpose(1, 2) @ a
    ab = a.transpose(1, 2) @ b
    bb = b.transpose(1, 2) @ b
    return (aa.square().sum() - 2.0 * ab.square().sum() + bb.square().sum()) / (n * r * r)


def triplet_cosine(anchor, pos, neg, *, margin: float = 0.1):
    """-> (loss, mean positive distance, mean negative distance); distances
    are 1 - cosine of the L2-normalized embeddings; in fp32."""
    a = l2_normalize(anchor.float(), axis=1)
    pos_d = 1.0 - torch.sum(a * l2_normalize(pos.float(), axis=1), dim=1)
    neg_d = 1.0 - torch.sum(a * l2_normalize(neg.float(), axis=1), dim=1)
    loss = torch.mean(torch.clamp_min(pos_d - neg_d + margin, 0))
    return loss, pos_d.mean(), neg_d.mean()


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    self_similarity: torch.Tensor  # weighted items, as the reference logs them
    triplet: torch.Tensor
    identity: torch.Tensor
    classifier: torch.Tensor
    pos_dist: torch.Tensor
    neg_dist: torch.Tensor
    accuracy: torch.Tensor


def _ss_space(x, impl):
    """ss_space of an NCHW map. The kernel computes both Grams in one
    launch, as the Pallas kernel does; the plain path builds ss_space alone
    (the JAX package's unused ss_channel is dead code that XLA removes)."""
    if impl == "kernel":
        return self_similarity(x, impl="kernel")[0]
    pos = x.reshape(x.shape[0], x.shape[1], -1).transpose(1, 2)
    return cosine_sim(pos, pos)


def _rows(x):
    """NCHW -> (N, C, HW): one row per channel."""
    return x.reshape(x.shape[0], x.shape[1], -1)


def ffrnet_objective(*, featmap_non, embed_non, embed_ocl, out_non, out_ocl, labels,
                     loss_weight: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                     faithful_ce_weight: bool = True, ss_impl: str = "plain",
                     ss_loss_impl: str = "factored", class_offset: int = 0,
                     class_group=None) -> LossBreakdown:
    """The weighted objective from the two branches' RecNetTrainOut.

    featmap_non: (N, C, H, W) frozen clean map; embed_*: (N, C) frozen
    embeddings; labels (N,). ss_loss_impl 'factored' takes the channel
    Grams' MSEs by `gram_mse_factored`; 'materialized' builds the Grams (the
    reference's dataflow), and so does ss_impl='kernel' always, whose kernel
    makes them anyway. The spatial Grams (N, HW, HW) are small and built in
    both modes. class_offset, class_group: the outputs' logits and cosines
    are the class shard [class_offset, ...) of a head sharded over the
    model group `class_group`; the cross-entropy and the accuracy's argmax
    then run over every shard.
    """
    w3 = float(loss_weight[3])
    factored = ss_loss_impl == "factored" and ss_impl != "kernel"
    if factored:
        ss_space = _ss_space(featmap_non, ss_impl)
    else:
        ss_space, ss_channel = self_similarity(featmap_non, impl=ss_impl)
    ss_space_loss = (mse(ss_space, _ss_space(out_non.feat_space, ss_impl))
                     + mse(ss_space, _ss_space(out_ocl.feat_space, ss_impl))) / 2
    if factored:
        cf = _rows(featmap_non)
        ss_channel_loss = (gram_mse_factored(cf, _rows(out_non.feat_channel))
                           + gram_mse_factored(cf, _rows(out_ocl.feat_channel))) / 2
    else:
        ss_channel_non = self_similarity(out_non.feat_channel, impl=ss_impl)[1]
        ss_channel_ocl = self_similarity(out_ocl.feat_channel, impl=ss_impl)[1]
        ss_channel_loss = (mse(ss_channel, ss_channel_non)
                           + mse(ss_channel, ss_channel_ocl)) / 2
    item0 = (ss_space_loss + ss_channel_loss) / 2

    item1, pos_d, neg_d = triplet_cosine(out_ocl.feat_new_v, embed_non, embed_ocl)
    item2 = (mse(out_non.feat_new_v, embed_non) + mse(out_ocl.feat_new_v, embed_non)) / 2
    shard = dict(offset=class_offset, group=class_group)
    ce_non = cross_entropy(out_non.logits, labels, **shard)
    ce_ocl = cross_entropy(out_ocl.logits, labels, **shard)
    item3 = ce_non / (1e-8 + w3) + ce_ocl if faithful_ce_weight else ce_non + ce_ocl

    items = [item * float(wt) for item, wt in zip((item0, item1, item2, item3), loss_weight)]
    total = items[0] + items[1] + items[2] + items[3]
    # masked-branch train accuracy from the raw cosines
    accuracy = (argmax_classes(out_ocl.cosine, **shard) == labels).float().mean()
    return LossBreakdown(total, items[0], items[1], items[2], items[3], pos_d, neg_d, accuracy)
