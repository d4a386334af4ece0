"""Squeeze-excitation gate: CUDA kernel (csrc/se_gating.cu) and plain twin.

Replaces ffrnet_tpu/ops/pallas/se_gating.py::se_gating_pallas. The kernel's
source note gives its bound (bytes: 3.65 GB per IR-SE50 forward at N=256
in fp32) and its design: one thread-block-cluster launch per gate, a
cluster of K CTAs holding each sample's map in shared memory, so that x is
read once and written once. `_se_plan` picks K.

The wrapper calls the operator `ffrnet::se_gating` (`_ops.py`): the
kernel for CUDA tensors, the plain twin for CPU ones, chosen by PyTorch's
dispatcher. It is differentiable (the Pallas kernel's custom VJP,
ffrnet_tpu/ops/pallas/se_gating.py:71-86): its backward is the VJP of the
plain twin at the saved x, w1 and w2.
"""

from __future__ import annotations

import ctypes

import torch

from ffrnet_torch.ops.kernels import _build
from ffrnet_torch.ops.kernels._autograd import plain_vjp
from ffrnet_torch.ops.kernels._ops import define

_DTYPES = (torch.float32, torch.bfloat16)

# mirrors of se_gating.cu's kThreads, kMaxChunks and kMaxCluster
THREADS = 256
MAX_CHUNKS = 8
MAX_CLUSTER = 8
# an H100 SM's shared memory (228 KB), and what the runtime keeps of it
# for each resident CTA
SM_SMEM = 233_472
CTA_RESERVED = 1_024

_cluster_checked: set = set()


def se_gating_plain(x, w1, w2):
    """x (N, C, H, W); w1 (C/r, C); w2 (C, C/r). Pool and gate in fp32, the
    gate cast to x's dtype before the multiply (the Pallas kernel's math)."""
    pooled = x.float().mean(dim=(2, 3))
    hid = torch.clamp_min(pooled @ w1.float().T, 0)
    gate = torch.sigmoid(hid @ w2.float().T).to(x.dtype)
    return x * gate[:, :, None, None]


def _smem_bytes(cpc: int, hw: int, r: int, itemsize: int) -> int:
    """Shared memory of one CTA holding `cpc` channels (se_gating.cu's
    `layout`): the slice, the mbarriers, the pool's partial sums, the
    means/gates and the partial and final hidden values."""
    segs = -(-THREADS // cpc)
    return cpc * hw * itemsize + 8 * MAX_CHUNKS + 4 * (cpc * segs + cpc + 2 * r)


def _se_plan(c: int, hw: int, r: int, itemsize: int, ctas_per_sm: int | None = None):
    """(cluster, channels_per_cta, smem_bytes) for a (C, HW) map of
    `itemsize`-byte values and R hidden units: the smallest cluster of 1, 2,
    4 or 8 CTAs whose channel slices are multiples of 16 bytes (the bulk
    copy's unit) and fit `ctas_per_sm` CTAs on an SM. By default two fp32 or
    four bf16 CTAs, so that both types take the same clusters: a bf16 map
    in slices half the bytes measured faster on an H100 than in half as
    many CTAs. Raises ValueError for a map that no such cluster holds."""
    ctas_per_sm = ctas_per_sm or 8 // itemsize
    budget = SM_SMEM // ctas_per_sm - CTA_RESERVED
    cluster = 1
    while cluster <= MAX_CLUSTER:
        cpc = c // cluster
        if c % cluster == 0 and cpc * hw * itemsize % 16 == 0:
            smem = _smem_bytes(cpc, hw, r, itemsize)
            if smem <= budget:
                return cluster, cpc, smem
        cluster *= 2
    raise ValueError(
        f"se_gating: a ({c}, {hw}) map of {itemsize}-byte values fits no cluster of at most "
        f"{MAX_CLUSTER} CTAs with {budget} bytes of shared memory each ({ctas_per_sm} per SM) "
        f"and channel slices in multiples of 16 bytes")


def _check_cluster(cluster: int, smem: int, is_bf16: int, stream: int) -> None:
    """Raise unless clusters of this plan can be resident at all; asked once
    per plan."""
    key = (cluster, smem, is_bf16)
    if key in _cluster_checked:
        return
    count = ctypes.c_int(0)
    fn = _build.load("se_gating", "se_gating_max_clusters", 1, 3)
    _build.check_launch("se_gating (occupancy query)",
                        fn(ctypes.addressof(count), cluster, smem, is_bf16, stream))
    if count.value == 0:
        raise RuntimeError(f"se_gating: no cluster of {cluster} CTAs with {smem} bytes of "
                           f"shared memory each fits on this card")
    _cluster_checked.add(key)


def _launch(x, w1, w2, plan):
    """One launch of the kernel on checked, contiguous CUDA tensors: a
    cluster of plan[0] CTAs per sample."""
    n, c, h, w = x.shape
    cluster, cpc, smem = plan
    is_bf16 = int(x.dtype == torch.bfloat16)
    stream = _build.stream_handle(x.device)
    _check_cluster(cluster, smem, is_bf16, stream)
    out = torch.empty_like(x)
    fn = _build.load("se_gating", "se_gating_launch", 4, 8)
    rc = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(), n, c, h * w,
            w1.shape[0], cluster, cpc, smem, is_bf16, stream)
    _build.check_launch("se_gating", rc)
    se_gating.launches += 1
    return out


def se_gating(x, w1, w2):
    """SE gate of an NCHW map: the plain version on the CPU, the kernel on
    a CUDA tensor; the gradient is the plain version's."""
    return _OP(x, w1, w2)


def _checked_launch(x, w1, w2):
    """The checks, then one launch, on CUDA tensors."""
    n, c, h, w = x.shape
    r = w1.shape[0]
    if x.dtype not in _DTYPES or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(f"se_gating: x, w1, w2 must share float32 or bfloat16, "
                        f"got {x.dtype}, {w1.dtype}, {w2.dtype}")
    if tuple(w1.shape) != (r, c) or tuple(w2.shape) != (c, r):
        raise ValueError(f"se_gating: weights {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} do not fit C={c}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("se_gating: x must be 16-byte aligned")
    plan = _se_plan(c, h * w, r, x.element_size())
    return _launch(x, w1.contiguous(), w2.contiguous(), plan)


def _cpu(x, w1, w2):
    return se_gating_plain(x.contiguous(), w1, w2)


def _fake(x, w1, w2):
    return x.new_empty(x.shape)


def _backward(ctx, grad):
    return plain_vjp(se_gating_plain, ctx.saved_tensors, (grad,), ctx.needs_input_grad)


_OP = define("se_gating(Tensor x, Tensor w1, Tensor w2) -> Tensor", cpu=_cpu,
             cuda=_checked_launch, fake=_fake, backward=_backward)
se_gating.launches = 0
