"""Squeeze-excitation gate: CUDA kernel (csrc/se_gating.cu) and plain twin.

Replaces ffrnet_tpu/ops/pallas/se_gating.py::se_gating_pallas. The kernel's
source note gives its bound (bytes: 3.65 GB per IR-SE50 forward at N=256
in fp32) and its design (pool, gate and scale as three launches that each
fill the card, since one sample's 56x56x64 map exceeds a block's shared
memory).
"""

from __future__ import annotations

import torch

from ffrnet_torch.ops.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)


def se_gating_plain(x, w1, w2):
    """x (N, C, H, W); w1 (C/r, C); w2 (C, C/r). Pool and gate in fp32, the
    gate cast to x's dtype before the multiply (the Pallas kernel's math)."""
    pooled = x.float().mean(dim=(2, 3))
    hid = torch.clamp_min(pooled @ w1.float().T, 0)
    gate = torch.sigmoid(hid @ w2.float().T).to(x.dtype)
    return x * gate[:, :, None, None]


def se_gating(x, w1, w2):
    """SE gate of an NCHW map: the plain version on the CPU, the kernel on
    a CUDA tensor."""
    if x.device.type == "cpu":
        return se_gating_plain(x, w1, w2)
    if x.device.type != "cuda":
        raise ValueError(f"se_gating: unsupported device {x.device}")
    n, c, h, w = x.shape
    r = w1.shape[0]
    if x.dtype not in _DTYPES or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(f"se_gating: x, w1, w2 must share float32 or bfloat16, "
                        f"got {x.dtype}, {w1.dtype}, {w2.dtype}")
    if tuple(w1.shape) != (r, c) or tuple(w2.shape) != (c, r):
        raise ValueError(f"se_gating: weights {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} do not fit C={c}")
    if (n * c * h * w) % 4:
        raise ValueError("se_gating: N*C*H*W must be a multiple of 4")
    x = x.contiguous()
    if x.data_ptr() % (4 * x.element_size()):
        raise ValueError("se_gating: x must be aligned to 4 elements")
    w1 = w1.contiguous()
    w2 = w2.contiguous()
    out = torch.empty_like(x)
    pooled = torch.empty((n, c), device=x.device, dtype=torch.float32)
    gate = torch.empty_like(pooled)
    fn = _build.load("se_gating", "se_gating_launch", 6, 5)
    rc = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(),
            pooled.data_ptr(), gate.data_ptr(), n, c, h * w, r,
            int(x.dtype == torch.bfloat16), _build.stream_handle(x.device))
    _build.check_launch("se_gating", rc)
    se_gating.launches += 1
    return out


se_gating.launches = 0
