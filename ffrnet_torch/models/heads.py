"""Margin heads of the reference's model zoo (ffrnet_tpu/models/heads.py).

RecNet trains with AddMarginProduct (CosFace); the reference also ships:

  * `Arcface`   cos(theta + m) on the target class with the [0, pi] guard,
                scaled by s (pretrain/model_ir_se50.py:256-293)
  * `AmSoftmax` cos(theta) - m on the target class, scaled by s
                (pretrain/model_ir_se50.py:297-319)

Both keep the reference's column layout: one parameter `kernel` of shape
(embedding_size, classnum), L2-normalized over the embedding axis at each
call. The product `embeddings @ kernel` is a plain torch.matmul (the JAX
package computes it outside any Pallas kernel). `add_margin_logits` and
`arc_margin_logits`, the row-layout heads of RecNet, are re-exported from
models/recnet.py.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ffrnet_torch.models.recnet import _one_hot, add_margin_logits, arc_margin_logits  # noqa: F401
from ffrnet_torch.ops.nn import l2_norm_div


def init_kernel(embedding_size: int = 512, classnum: int = 51332, *, generator=None,
                dtype=torch.float32):
    """uniform(-1, 1), then each column scaled to unit norm: the reference's
    renorm to 1e-5 times 1e5 (pretrain/model_ir_se50.py:263)."""
    k = torch.rand((embedding_size, classnum), generator=generator, dtype=dtype) * 2 - 1
    norms = torch.sqrt(torch.sum(k * k, dim=0, keepdim=True))
    return k / torch.clamp_min(norms, 1e-12)


def _cosines(kernel, embeddings):
    return torch.clamp(torch.matmul(embeddings, l2_norm_div(kernel, axis=0)), -1.0, 1.0)


def arcface_logits(kernel, embeddings, label, *, s: float = 64.0, m: float = 0.5):
    """kernel (E, classes), embeddings (N, E), label (N,) -> logits (N,
    classes). Where theta + m leaves [0, pi] (cos <= cos(pi - m)) the
    target logit falls back to cos - sin(m) m, as the reference does."""
    cos = _cosines(kernel, embeddings)
    sin = torch.sqrt(1.0 - cos.square())
    cos_m, sin_m = math.cos(m), math.sin(m)
    cos_theta_m = cos * cos_m - sin * sin_m
    keep = cos - sin_m * m
    cos_theta_m = torch.where(cos - math.cos(math.pi - m) <= 0, keep, cos_theta_m)
    one_hot = _one_hot(label, cos)
    return s * torch.where(one_hot > 0, cos_theta_m, cos)


def am_softmax_logits(kernel, embeddings, label, *, s: float = 30.0, m: float = 0.35):
    """kernel (E, classes), embeddings (N, E), label (N,) -> logits (N,
    classes): s (cos - m) on the target class, s cos elsewhere."""
    cos = _cosines(kernel, embeddings)
    one_hot = _one_hot(label, cos)
    return s * torch.where(one_hot > 0, cos - m, cos)


class Arcface(nn.Module):
    """forward(embeddings (N, E), label (N,)) -> logits (N, classnum)."""

    def __init__(self, embedding_size: int = 512, classnum: int = 51332, *, s: float = 64.0,
                 m: float = 0.5, generator=None):
        super().__init__()
        self.s, self.m = s, m
        self.kernel = nn.Parameter(init_kernel(embedding_size, classnum, generator=generator))

    def forward(self, embeddings, label):
        return arcface_logits(self.kernel, embeddings, label, s=self.s, m=self.m)


class AmSoftmax(nn.Module):
    """forward(embeddings (N, E), label (N,)) -> logits (N, classnum)."""

    def __init__(self, embedding_size: int = 512, classnum: int = 51332, *, s: float = 30.0,
                 m: float = 0.35, generator=None):
        super().__init__()
        self.s, self.m = s, m
        self.kernel = nn.Parameter(init_kernel(embedding_size, classnum, generator=generator))

    def forward(self, embeddings, label):
        return am_softmax_logits(self.kernel, embeddings, label, s=self.s, m=self.m)
