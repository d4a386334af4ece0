"""Fused self-similarity: CUDA kernel (csrc/self_similarity.cu) and plain twin.

Replaces ffrnet_tpu/ops/pallas/self_similarity.py::self_similarity_pallas.
Bound (at C=512, HW=49, N=256, fp32): 0.30 GB of I/O, 0.0885 ms (bytes);
the symmetric Grams need 3.6 GFLOP, 0.054 ms. The kernel tiles ss_channel
into 64x64 blocks so that many blocks keep both the SIMT units and the
memory busy (see the source note).
"""

from __future__ import annotations

import torch

from ffrnet_torch.ops.kernels import _build

_EPS = 1e-12
_DTYPES = (torch.float32, torch.bfloat16)


def self_similarity_fused_plain(x):
    """x (N, C, H, W) -> (ss_space (N, HW, HW), ss_channel (N, C, C)):
    both Grams in fp32, scaled by the outer product of the rows' inverse
    norms 1/max(||.||, 1e-12), cast to x's dtype (the Pallas kernel's math)."""
    n, c, h, w = x.shape
    xf = x.reshape(n, c, h * w).float()          # rows = channels
    gp = torch.bmm(xf.transpose(1, 2), xf)       # (N, HW, HW)
    gc = torch.bmm(xf, xf.transpose(1, 2))       # (N, C, C)
    sq = xf * xf
    inv_r = 1.0 / torch.clamp_min(torch.sqrt(sq.sum(dim=1)), _EPS)  # (N, HW)
    inv_s = 1.0 / torch.clamp_min(torch.sqrt(sq.sum(dim=2)), _EPS)  # (N, C)
    ss_space = gp * inv_r[:, :, None] * inv_r[:, None, :]
    ss_channel = gc * inv_s[:, :, None] * inv_s[:, None, :]
    return ss_space.to(x.dtype), ss_channel.to(x.dtype)


def self_similarity_fused(x):
    """Both self-similarity Grams of an NCHW map: the plain version on the
    CPU, the kernel on a CUDA tensor."""
    if x.device.type == "cpu":
        return self_similarity_fused_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"self_similarity: unsupported device {x.device}")
    n, c, h, w = x.shape
    hw = h * w
    if x.dtype not in _DTYPES:
        raise TypeError(f"self_similarity: float32 or bfloat16, got {x.dtype}")
    if c % 64 or hw > 64:
        raise ValueError(f"self_similarity: needs C % 64 == 0 and H*W <= 64, "
                         f"got C={c}, H*W={hw}")
    x = x.contiguous()
    ss_space = torch.empty((n, hw, hw), device=x.device, dtype=x.dtype)
    ss_channel = torch.empty((n, c, c), device=x.device, dtype=x.dtype)
    fn = _build.load("self_similarity", "self_similarity_launch", 3, 4)
    rc = fn(x.data_ptr(), ss_space.data_ptr(), ss_channel.data_ptr(), n, c, hw,
            int(x.dtype == torch.bfloat16), _build.stream_handle(x.device))
    _build.check_launch("self_similarity", rc)
    self_similarity_fused.launches += 1
    return ss_space, ss_channel


self_similarity_fused.launches = 0
