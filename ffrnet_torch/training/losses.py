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


def cross_entropy(logits, labels):
    """Mean softmax cross-entropy over the batch, in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, 1, labels[:, None].long())[:, 0]
    return torch.mean(logz - true_logit)


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
                     ss_loss_impl: str = "factored") -> LossBreakdown:
    """The weighted objective from the two branches' RecNetTrainOut.

    featmap_non: (N, C, H, W) frozen clean map; embed_*: (N, C) frozen
    embeddings; labels (N,). ss_loss_impl 'factored' takes the channel
    Grams' MSEs by `gram_mse_factored`; 'materialized' builds the Grams (the
    reference's dataflow), and so does ss_impl='kernel' always, whose kernel
    makes them anyway. The spatial Grams (N, HW, HW) are small and built in
    both modes.
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
    ce_non = cross_entropy(out_non.logits, labels)
    ce_ocl = cross_entropy(out_ocl.logits, labels)
    item3 = ce_non / (1e-8 + w3) + ce_ocl if faithful_ce_weight else ce_non + ce_ocl

    items = [item * float(wt) for item, wt in zip((item0, item1, item2, item3), loss_weight)]
    total = items[0] + items[1] + items[2] + items[3]
    # masked-branch train accuracy from the raw cosines
    accuracy = (out_ocl.cosine.argmax(dim=1) == labels).float().mean()
    return LossBreakdown(total, items[0], items[1], items[2], items[3], pos_d, neg_d, accuracy)
