"""Fused RecNet channel branch: CUDA kernel (csrc/channel_branch.cu), plain
twin and the fp32 weight prep `_collapse`.

Replaces ffrnet_tpu/ops/pallas/channel_branch.py::channel_branch_pallas.
Bound (at C=512, HW=49, N=256, fp32): 12.6 GFLOP, 0.19 ms on fp32 SIMT;
the (C, C) attention matrix stays in shared memory, one block per 64 of
its rows (see the source note).

Output layout: (N, C, HW), which is NCHW. The JAX kernel returns the
transpose, (N, HW, C).
"""

from __future__ import annotations

import torch

from ffrnet_torch.ops.kernels import _build

_EPS = 1e-12
_DTYPES = (torch.float32, torch.bfloat16)


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
    CPU, the kernel on a CUDA tensor. `weights` come from `_collapse`."""
    if flat.device.type == "cpu":
        return channel_branch_plain(flat, weights)
    if flat.device.type != "cuda":
        raise ValueError(f"channel_branch: unsupported device {flat.device}")
    n, c, hw = flat.shape
    if flat.dtype not in _DTYPES:
        raise TypeError(f"channel_branch: float32 or bfloat16, got {flat.dtype}")
    if c % 64 or hw > 56:
        raise ValueError(f"channel_branch: needs C % 64 == 0 and HW <= 56, "
                         f"got C={c}, HW={hw}")
    shapes = [(32, hw), (32, c), (32,), (c,), (32, 32), (32,), (c,),
              (32, 32), (32,), (c,), (c, 32), (c,)]
    for wt, shape in zip(weights, shapes):
        if (tuple(wt.shape) != shape or wt.dtype != torch.float32
                or wt.device != flat.device or not wt.is_contiguous()):
            raise ValueError(
                f"channel_branch: weight {tuple(wt.shape)} {wt.dtype} on "
                f"{wt.device}, expected contiguous float32 {shape} on "
                f"{flat.device}")
    flat = flat.contiguous()
    out = torch.empty_like(flat)
    inv_r = torch.empty((n, c), device=flat.device, dtype=torch.float32)
    t = torch.empty((n, 32, hw), device=flat.device, dtype=torch.float32)
    fn = _build.load("channel_branch", "channel_branch_launch", 16, 4)
    rc = fn(flat.data_ptr(), *(wt.data_ptr() for wt in weights),
            inv_r.data_ptr(), t.data_ptr(), out.data_ptr(), n, c, hw,
            int(flat.dtype == torch.bfloat16), _build.stream_handle(flat.device))
    _build.check_launch("channel_branch", rc)
    channel_branch.launches += 1
    return out


channel_branch.launches = 0
