"""Self-similarity (cosine Gram matrices), the FFR-Net core primitive.

Counterpart of ffrnet_tpu/ops/similarity.py. For a feature map flattened to
(N, C, HW):

  ss_space   = cosine similarity between spatial positions -> (N, HW, HW)
  ss_channel = cosine similarity between channels          -> (N, C, C)

The port takes NCHW input; its (N, C, HW) view is free.
"""

from __future__ import annotations

import torch

from ffrnet_torch.ops.kernels.self_similarity import self_similarity_fused
from ffrnet_torch.ops.nn import l2_normalize

_EPS = 1e-12  # F.normalize default


def cosine_sim(x1, x2, *, eps: float = _EPS):
    """Batched cosine-similarity Gram of rows: (N, R, D) x (N, S, D) ->
    (N, R, S), normalizing over dim 2 and then `torch.bmm`."""
    x1 = l2_normalize(x1, axis=2, eps=eps)
    x2 = l2_normalize(x2, axis=2, eps=eps)
    return torch.bmm(x1, x2.transpose(1, 2))


def self_similarity(x_nchw, *, impl: str = "plain"):
    """(ss_space (N, HW, HW), ss_channel (N, C, C)) of an NCHW map.

    impl="plain" normalizes the rows and multiplies (the JAX package's XLA
    path); impl="kernel" goes through the fused self-similarity wrapper,
    which launches the CUDA kernel on a CUDA tensor and differentiates as
    its plain version.
    """
    if impl == "kernel":
        return self_similarity_fused(x_nchw)
    if impl != "plain":
        raise ValueError(f"self_similarity impl must be 'plain' or 'kernel', "
                         f"got {impl!r}")
    n, c, h, w = x_nchw.shape
    chan = x_nchw.reshape(n, c, h * w)  # rows = channels
    pos = chan.transpose(1, 2)          # rows = spatial positions
    return cosine_sim(pos, pos), cosine_sim(chan, chan)
