"""int8 x int8 -> int32 convolution with a fused dequantizing epilogue: CUDA
kernel (csrc/int8_conv.cu), the operand layout it takes, and the plain twin.

Replaces XLA's int8 convolution and dot in ffrnet_tpu/ops/quant.py:143 and
:169 (no Pallas original). The kernel computes

    out[n, o, ho, wo] = fp32(acc) * deq[o]  (+ bias[o]),  cast to out_dtype,
    acc = sum over (r, s, c) of x[n, ho*stride - pad + r, wo*stride - pad + s, c]
                                * w[o, r, s, c]   in int32,

with x zero outside the map. Operands: `to_nhwc` gives the int8 activation
as (N, H, W, Cp), and `pack_weight` the int8 weight as (Coutp, KH, KW, Cp),
Cp and Coutp rounded up to multiples of 64 with zeros, which add exactly 0.
A Linear is the same product over a (N, 1, 1, K) map with a 1x1 window.

The plain twin computes the same integer product exactly (float64 on the
tensor's device: |acc| <= 127^2 * 25088 < 2^53) and then the epilogue's two
fp32 roundings, so kernel and twin agree to the bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ffrnet_torch.ops.kernels import _build

# mirrors of int8_conv.cu's BK (channels per K step) and BN (output
# channels per CTA): the packed operands are padded to whole tiles
K_ALIGN = 64
N_ALIGN = 64
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, KH, KW) or Linear (Cout, K) int8 -> (Coutp, KH, KW, Cinp)
    int8, channels last, zero rows and channels appended."""
    if wq.ndim == 2:
        wq = wq[:, :, None, None]
    cout, cin, kh, kw = wq.shape
    out = torch.zeros((_round_up(cout, N_ALIGN), kh, kw, _round_up(cin, K_ALIGN)),
                      dtype=torch.int8, device=wq.device)
    out[:cout, :, :, :cin] = wq.permute(0, 2, 3, 1)
    return out


def to_nhwc(xq: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) or (N, K) int8 -> contiguous (N, H, W, Cp) int8 with
    zero channels appended up to Cp, a multiple of 64."""
    if xq.ndim == 2:
        return F.pad(xq, (0, _round_up(xq.shape[1], K_ALIGN) - xq.shape[1]))[:, None, None, :]
    x = xq.permute(0, 2, 3, 1)
    c = x.shape[-1]
    if c % K_ALIGN:
        x = F.pad(x, (0, _round_up(c, K_ALIGN) - c))
    return x.contiguous()


def _out_hw(h, w, kh, kw, stride, padding):
    return (h + 2 * padding - kh) // stride + 1, (w + 2 * padding - kw) // stride + 1


def _check(xq, wp, deq, bias, stride, padding, out_dtype):
    if xq.dtype != torch.int8 or wp.dtype != torch.int8:
        raise TypeError(f"int8_conv: int8 operands, got {xq.dtype} and {wp.dtype}")
    if xq.ndim != 4 or wp.ndim != 4 or xq.shape[3] != wp.shape[3]:
        raise ValueError(f"int8_conv: x (N, H, W, Cp) and w (Coutp, KH, KW, Cp), got "
                         f"{tuple(xq.shape)} and {tuple(wp.shape)}")
    if xq.shape[3] % K_ALIGN or wp.shape[0] % N_ALIGN:
        raise ValueError(f"int8_conv: Cp % {K_ALIGN} and Coutp % {N_ALIGN} must be 0, got "
                         f"{xq.shape[3]} and {wp.shape[0]} (to_nhwc / pack_weight pad them)")
    if deq.dtype != torch.float32 or deq.ndim != 1 or not 0 < deq.shape[0] <= wp.shape[0]:
        raise ValueError(f"int8_conv: deq fp32 (Cout,) with Cout <= {wp.shape[0]}, got "
                         f"{deq.dtype} {tuple(deq.shape)}")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != tuple(deq.shape)):
        raise ValueError(f"int8_conv: bias fp32 {tuple(deq.shape)}, got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int8_conv: out_dtype float32 or bfloat16, got {out_dtype}")
    if stride < 1 or padding < 0 or min(_out_hw(xq.shape[1], xq.shape[2], wp.shape[1],
                                                wp.shape[2], stride, padding)) < 1:
        raise ValueError(f"int8_conv: stride {stride}, padding {padding} on "
                         f"{tuple(xq.shape)} with a {wp.shape[1]}x{wp.shape[2]} window")
    devs = {t.device for t in (xq, wp, deq) + ((bias,) if bias is not None else ())}
    if len(devs) != 1:
        raise ValueError(f"int8_conv: operands on several devices {devs}")


def int8_conv_plain(xq, wp, deq, bias=None, *, stride=1, padding=0, out_dtype=torch.float32):
    """The kernel's function as PyTorch ops: the integer product in float64
    (exact) on the tensors' device, then fp32(acc) * deq, then + bias, each
    rounded to fp32, then the cast."""
    n, h, w, _ = xq.shape
    _, kh, kw, _ = wp.shape
    cout = deq.shape[0]
    ho, wo = _out_hw(h, w, kh, kw, stride, padding)
    cols = F.unfold(xq.permute(0, 3, 1, 2).double(), (kh, kw), padding=padding,
                    stride=stride)                                # (N, Cp KH KW, L), (c, r, s)
    wmat = wp[:cout].permute(0, 3, 1, 2).reshape(cout, -1).double()
    acc = torch.matmul(wmat, cols).reshape(n, cout, ho, wo)      # exact integers
    y = acc.float() * deq.reshape(1, -1, 1, 1)
    if bias is not None:
        y = y + bias.reshape(1, -1, 1, 1)
    return y.to(out_dtype)


def int8_conv(xq, wp, deq, bias=None, *, stride=1, padding=0, out_dtype=torch.float32):
    """(N, H, W, Cp) int8 x (Coutp, KH, KW, Cp) int8 -> (N, Cout, Ho, Wo) in
    out_dtype, Cout = len(deq): the plain version on the CPU, the kernel on
    a CUDA tensor."""
    _check(xq, wp, deq, bias, stride, padding, out_dtype)
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, wp, deq, bias, stride=stride, padding=padding,
                               out_dtype=out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {xq.device}")
    return _launch(xq, wp, deq, bias, stride, padding, out_dtype)


def _aligned(t):
    """Contiguous, and 16-byte aligned for the kernel's 16-byte copies."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _launch(xq, wp, deq, bias, stride, padding, out_dtype):
    n, h, w, cp = xq.shape
    coutp, kh, kw, _ = wp.shape
    cout = deq.shape[0]
    ho, wo = _out_hw(h, w, kh, kw, stride, padding)
    xq, wp, deq = _aligned(xq), _aligned(wp), deq.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((n, cout, ho, wo), device=xq.device, dtype=out_dtype)
    fn = _build.load("int8_conv", "int8_conv_launch", 5, 13)
    rc = fn(xq.data_ptr(), wp.data_ptr(), deq.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), n, h, w, cp, cout,
            coutp, kh, kw, stride, padding, ho, wo, int(out_dtype == torch.bfloat16),
            _build.stream_handle(xq.device))
    _build.check_launch("int8_conv", rc)
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
