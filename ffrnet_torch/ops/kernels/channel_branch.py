"""Fused RecNet channel branch: CUDA kernel (csrc/channel_branch.cu), plain
twin, the fp32 weight prep `_collapse` and the launch plan `_cb_plan`.

Replaces ffrnet_tpu/ops/pallas/channel_branch.py::channel_branch_pallas.
The kernel is a sigmoid attention per sample (queries h, keys W5 with bias
b5, values X) in one thread-block-cluster launch: the cluster's CTAs share
the only reduction over all rows (t) through distributed shared memory,
and each warp keeps 16 rows of the (C, C) matrix M in registers between
two tensor-core products (mma.sync m16n8k8, TF32). Each product is split
into TF32 hi/lo parts (3xTF32; 2 products for M X in bf16, whose X is
exact in TF32): one TF32 pass puts the output about 100x the fp32 bound of
1e-4 off the plain version (tests/test_torch_cb_split.py).
Bound at C=512, HW=49, N=256, fp32: 0.066 ms (the products as 3xTF32 at
495 TFLOP/s); 0.189 ms if every operation ran on fp32 SIMT; bf16 0.053 ms.

Output layout: (N, C, HW), which is NCHW. The JAX kernel returns the
transpose, (N, HW, C).

The wrapper calls the operator `ffrnet::channel_branch` (`_ops.py`): the
kernel for CUDA tensors, the plain twin for CPU ones, chosen by PyTorch's
dispatcher. It is differentiable (the Pallas kernel's custom VJP,
ffrnet_tpu/ops/pallas/channel_branch.py:150-168): its backward is the VJP
of the plain twin at the saved flat and `_collapse` operands, and
`_collapse` is PyTorch ops, so the gradient reaches the Conv4Channel
weights too.
"""

from __future__ import annotations

import torch

from ffrnet_torch.ops.kernels import _build
from ffrnet_torch.ops.kernels._autograd import plain_vjp
from ffrnet_torch.ops.kernels._ops import define

_EPS = 1e-12
_DTYPES = (torch.float32, torch.bfloat16)
ROWS = 64        # rows of M a CTA takes at once (4 warps of 16)
MAX_CLUSTER = 8  # the portable cluster size


def _cb_plan(c: int) -> tuple:
    """(cluster, rows): the CTAs per sample and the rows of M each owns.

    A cluster of up to MAX_CLUSTER CTAs, a power of two, shares one sample;
    each CTA owns `rows` = C / cluster rows, a multiple of ROWS (64 at
    C=512, in 8 CTAs).
    """
    if c < ROWS or c % ROWS:
        raise ValueError(f"channel_branch: needs C % {ROWS} == 0, got C={c}")
    cluster = MAX_CLUSTER
    while (c // ROWS) % cluster:
        cluster //= 2
    return cluster, c // cluster


def _collapse(params):
    """Split lin0 by input block and collapse the two inter-block Linear
    pairs into (32, 32) affines, all in fp32 (exact up to reassociation).

    `params` is the Conv4Channel tree: {"lin0".."lin5": {"w", "b" or None},
    "prelu0".."prelu2": {"slope"}}. Returns the 12 operands of the kernel:
    (w1f, w1s, b1, s0, wc1, bc1, s1, wc2, bc2, s2, w5, b5).
    """
    f32 = torch.float32
    w1 = params["lin0"]["w"].to(f32)  # (32, HW + C)
    c = params["lin5"]["w"].shape[0]
    q = w1.shape[1] - c
    w1f, w1s = w1[:, :q], w1[:, q:]
    b1 = params["lin0"].get("b")
    b1 = (torch.zeros(w1.shape[0], dtype=f32, device=w1.device) if b1 is None
          else b1.to(f32))

    def pair(i):
        pa, pb = params[f"lin{2 * i - 1}"], params[f"lin{2 * i}"]
        wb = pb["w"].to(f32)
        wc = wb @ pa["w"].to(f32)
        ba, bb = pa.get("b"), pb.get("b")
        bc = torch.zeros(wc.shape[0], dtype=f32, device=wc.device)
        if ba is not None:
            bc = wb @ ba.to(f32)
        if bb is not None:
            bc = bc + bb.to(f32)
        return wc, bc

    wc1, bc1 = pair(1)
    wc2, bc2 = pair(2)
    w5 = params["lin5"]["w"].to(f32)
    b5 = params["lin5"].get("b")
    b5 = (torch.zeros(c, dtype=f32, device=w5.device) if b5 is None
          else b5.to(f32))
    s0, s1, s2 = (params[f"prelu{i}"]["slope"].to(f32) for i in range(3))
    return tuple(t.contiguous() for t in
                 (w1f, w1s, b1, s0, wc1, bc1, s1, wc2, bc2, s2, w5, b5))


def channel_branch_plain(flat, weights):
    """flat (N, C, HW) and the `_collapse` operands -> (N, C, HW), all in
    fp32 inside and cast to flat's dtype (the Pallas kernel's math)."""
    w1f, w1s, b1, s0, wc1, bc1, s1, wc2, bc2, s2, w5, b5 = weights
    x = flat.float()
    inv_r = 1.0 / torch.clamp_min(
        torch.sqrt(torch.sum(x * x, dim=2, keepdim=True)), _EPS)
    ghat = x * inv_r
    h = x @ w1f.T
    t = torch.matmul(w1s, ghat)                  # (N, 32, HW)
    h = h + ghat @ t.transpose(1, 2)
    h = h + b1
    h = torch.where(h >= 0, h, s0[:, None] * h)  # PReLU over rows
    h = h @ wc1.T + bc1
    h = torch.where(h >= 0, h, s1[:, None] * h)
    h = h @ wc2.T + bc2
    h = torch.where(h >= 0, h, s2[:, None] * h)
    m = torch.sigmoid(h @ w5.T + b5)             # (N, C, C)
    return (m @ x).to(flat.dtype)


def channel_branch(flat, weights):
    """Fused channel branch of a (N, C, HW) map: the plain version on the
    CPU, the kernel on a CUDA tensor. `weights` come from `_collapse`; the
    gradient (to flat and to each weight) is the plain version's."""
    return _OP(flat, list(weights))


def _plain(flat, *weights):
    return channel_branch_plain(flat, weights)


def _fake(flat, weights):
    return flat.new_empty(flat.shape)


def _backward(ctx, grad):
    need_flat, need_weights = ctx.needs_input_grad
    grads = plain_vjp(_plain, ctx.saved_tensors, (grad,), (need_flat, *need_weights))
    return grads[0], list(grads[1:])


def _launch(flat, weights):
    """The checks, then one launch, on CUDA tensors."""
    n, c, hw = flat.shape
    if flat.dtype not in _DTYPES:
        raise TypeError(f"channel_branch: float32 or bfloat16, got {flat.dtype}")
    if c % ROWS or hw > 56:
        raise ValueError(f"channel_branch: needs C % {ROWS} == 0 and HW <= 56, "
                         f"got C={c}, HW={hw}")
    shapes = [(32, hw), (32, c), (32,), (c,), (32, 32), (32,), (c,),
              (32, 32), (32,), (c,), (c, 32), (c,)]
    if len(weights) != len(shapes):
        raise ValueError(f"channel_branch: {len(shapes)} weights, got {len(weights)}")
    for wt, shape in zip(weights, shapes):
        if (tuple(wt.shape) != shape or wt.dtype != torch.float32
                or wt.device != flat.device or not wt.is_contiguous()):
            raise ValueError(
                f"channel_branch: weight {tuple(wt.shape)} {wt.dtype} on "
                f"{wt.device}, expected contiguous float32 {shape} on "
                f"{flat.device}")
    if weights[10].data_ptr() % 16:
        raise ValueError("channel_branch: w5 must be 16-byte aligned")
    flat = flat.contiguous()
    if flat.data_ptr() % 16:  # the kernel copies X in 16-byte pieces
        flat = flat.clone()
    out = torch.empty_like(flat)
    cluster, _ = _cb_plan(c)
    fn = _build.load("channel_branch", "channel_branch_launch", 14, 5)
    rc = fn(flat.data_ptr(), *(wt.data_ptr() for wt in weights), out.data_ptr(),
            n, c, hw, cluster, int(flat.dtype == torch.bfloat16),
            _build.stream_handle(flat.device))
    _build.check_launch("channel_branch", rc)
    channel_branch.launches += 1
    return out


_OP = define("channel_branch(Tensor flat, Tensor[] weights) -> Tensor",
             cpu=channel_branch_plain, cuda=_launch, fake=_fake, backward=_backward)
channel_branch.launches = 0
