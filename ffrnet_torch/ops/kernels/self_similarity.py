"""Fused self-similarity: CUDA kernel (csrc/self_similarity.cu), its launch
plan `_ss_plan`, and the plain twin.

Replaces ffrnet_tpu/ops/pallas/self_similarity.py::self_similarity_pallas.
Bound at N=256, C=512, HW=49 on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32
SIMT): 0.0885 ms by bytes in fp32 (0.297 GB, 90% of it writing
ss_channel); 0.0542 ms by operations in bf16 (the two Grams' upper
triangles, 3.63 GFLOP on fp32 SIMT, against 0.0443 ms of bytes; the
kernel runs bf16's products on the tensor cores, where the bytes bound
it). The kernel is one launch for both Grams: one work item per sample
for ss_space, and one per upper-triangle 128x128 tile pair of
ss_channel, each stored as computed and transposed, so the output is
exactly symmetric (see the source note).

The wrapper calls the operator `ffrnet::self_similarity` (`_ops.py`): the
kernel for CUDA tensors, the plain twin for CPU ones, chosen by PyTorch's
dispatcher. It is differentiable (the Pallas kernel's custom VJP,
ffrnet_tpu/ops/pallas/self_similarity.py:86-103): its backward is the VJP
of the plain twin at the saved input, of one Gram's half where only one
was read. The kernel computes both Grams even where only one is
read, as the Pallas kernel does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ffrnet_torch.ops.kernels import _build
from ffrnet_torch.ops.kernels._autograd import plain_vjp
from ffrnet_torch.ops.kernels._ops import define

_EPS = 1e-12
_DTYPES = (torch.float32, torch.bfloat16)

# mirrors of self_similarity.cu's TILE, HALF, KMAX, KS, SS and kMaxSmem,
# and of the occupancy its __launch_bounds__ asks for (256 threads, at most
# 128 registers each: two CTAs fill an SM's 65,536 registers)
TILE = 128
HALF = 64
KMAX = 64
KS = 72
SS = 136
MAX_SMEM = 232_448
MAX_CTAS_PER_SM = 2
# an H100 SM's shared memory (228 KB), and what the runtime keeps of it
# for each resident CTA
SM_SMEM = 233_472
CTA_RESERVED = 1_024


class SsPlan(NamedTuple):
    tile: int         # ss_channel tile side (the last tile masked where it exceeds C)
    tiles: int        # T = ceil(C / tile)
    pairs: int        # upper-triangle tile pairs per sample, T(T+1)/2
    smem: int         # shared memory bytes per CTA
    ctas_per_sm: int  # CTAs an SM holds at once


def _smem_bytes(hw: int, itemsize: int) -> int:
    """Shared memory of one CTA (self_similarity.cu's `layout`): two
    128-row panels as copied (raw); the repacked panels, ss_space's panel
    and the staging, whichever is largest (pan): in bf16 two panels of
    (128, KS) bf16 rows or a (128, SS) bf16 staging tile, in fp32 two
    k-major fp32 panels or a 64x64 fp32 staging quadrant; then two panels'
    inverse norms, their partial sums of squares and two mbarriers."""
    raw = -(-2 * TILE * hw * itemsize // 16) * 16
    space = TILE * (-(-hw // 4) * 4) * 4
    if itemsize == 2:
        pan = max(2 * TILE * KS * 2, TILE * SS * 2, space)
    else:
        pan = max(2 * hw * TILE * 4, HALF * HALF * 4, space)
    return raw + pan + 2 * TILE * 4 + 2 * 2 * TILE * 4 + 2 * 8


def _ss_plan(c: int, hw: int, itemsize: int) -> SsPlan:
    """The launch plan for a (C, HW) map of `itemsize`-byte values: 128x128
    tiles of ss_channel (T = ceil(C/128) per side; where C is an odd
    multiple of 64 the last row and column of tiles hold one valid 64-wide
    half, and the kernel masks the other), T(T+1)/2 upper-triangle pairs
    per sample plus the sample's ss_space item, and the shared memory per
    CTA, which with the registers sets how many CTAs an SM holds (two at
    HW=49 in both types). Raises ValueError unless C % 64 == 0 and
    1 <= HW <= 64."""
    if c < HALF or c % HALF or not 1 <= hw <= KMAX:
        raise ValueError(f"self_similarity: needs C % {HALF} == 0 and 1 <= H*W <= {KMAX}, "
                         f"got C={c}, H*W={hw}")
    tiles = -(-c // TILE)
    pairs = tiles * (tiles + 1) // 2
    smem = _smem_bytes(hw, itemsize)
    ctas = min(MAX_CTAS_PER_SM, SM_SMEM // (smem + CTA_RESERVED))
    return SsPlan(TILE, tiles, pairs, smem, ctas)


def self_similarity_fused_plain(x):
    """x (N, C, H, W) -> (ss_space (N, HW, HW), ss_channel (N, C, C)):
    both Grams in fp32, scaled by the outer product of the rows' inverse
    norms 1/max(||.||, 1e-12), cast to x's dtype (the Pallas kernel's math)."""
    return _ss_space_plain(x), _ss_channel_plain(x)


def _ss_space_plain(x):
    n, c, h, w = x.shape
    xf = x.reshape(n, c, h * w).float()          # rows = channels
    gp = torch.bmm(xf.transpose(1, 2), xf)       # (N, HW, HW)
    inv_r = 1.0 / torch.clamp_min(torch.sqrt((xf * xf).sum(dim=1)), _EPS)  # (N, HW)
    return (gp * inv_r[:, :, None] * inv_r[:, None, :]).to(x.dtype)


def _ss_channel_plain(x):
    n, c, h, w = x.shape
    xf = x.reshape(n, c, h * w).float()
    gc = torch.bmm(xf, xf.transpose(1, 2))       # (N, C, C)
    inv_s = 1.0 / torch.clamp_min(torch.sqrt((xf * xf).sum(dim=2)), _EPS)  # (N, C)
    return (gc * inv_s[:, :, None] * inv_s[:, None, :]).to(x.dtype)


def self_similarity_fused(x):
    """Both self-similarity Grams of an NCHW map: the plain version on the
    CPU, the kernel on a CUDA tensor; the gradient is the plain version's."""
    return _OP(x)


def _fake(x):
    n, c, h, w = x.shape
    return x.new_empty((n, h * w, h * w)), x.new_empty((n, c, c))


def _backward(ctx, g_space, g_channel):
    """The VJP of the plain version at the saved x. Where one Gram was not
    read (its grad is None: the loss reads only ss_space of the rectified
    spatial maps and only ss_channel of the channel maps), only the other
    Gram is recomputed."""
    read = (g_space is not None, g_channel is not None)
    if not any(read) or not ctx.needs_input_grad[0]:
        return None
    plain = {(True, True): self_similarity_fused_plain, (True, False): _ss_space_plain,
             (False, True): _ss_channel_plain}[read]
    grads = tuple(g for g in (g_space, g_channel) if g is not None)
    return plain_vjp(plain, ctx.saved_tensors, grads, (True,))[0]


def _launch(x):
    """One launch of the kernel on a CUDA tensor, after the checks."""
    n, c, h, w = x.shape
    hw = h * w
    if x.dtype not in _DTYPES:
        raise TypeError(f"self_similarity: float32 or bfloat16, got {x.dtype}")
    plan = _ss_plan(c, hw, x.element_size())
    x = x.contiguous()
    if x.data_ptr() % 16:  # the bulk copy's unit: a fresh allocation is aligned
        x = x.clone()
    ss_space = torch.empty((n, hw, hw), device=x.device, dtype=x.dtype)
    ss_channel = torch.empty((n, c, c), device=x.device, dtype=x.dtype)
    fn = _build.load("self_similarity", "self_similarity_launch", 3, 6)
    rc = fn(x.data_ptr(), ss_space.data_ptr(), ss_channel.data_ptr(), n, c, hw, plan.pairs,
            plan.smem, int(x.dtype == torch.bfloat16), _build.stream_handle(x.device))
    _build.check_launch("self_similarity", rc)
    self_similarity_fused.launches += 1
    return ss_space, ss_channel


_OP = define("self_similarity(Tensor x) -> (Tensor, Tensor)",
             cpu=self_similarity_fused_plain, cuda=_launch, fake=_fake, backward=_backward)
self_similarity_fused.launches = 0
