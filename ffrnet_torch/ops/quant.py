"""Int8 quantized inference ops (ffrnet_tpu/ops/quant.py).

  - weights: symmetric per-output-channel int8, scale = max(amax, 1e-12)/127
    over the receptive field, quantized once when a site is made;
  - activations: symmetric per-tensor int8, from this batch's amax
    (dynamic) or from a calibrated `x_scale` (static; values beyond it
    saturate at +/-127);
  - the product: int8 x int8 -> int32, then fp32(acc) * fp32(s_x * s_w[o]),
    then + bias, cast to the activation's dtype. On a CUDA tensor it is the
    `int8_conv` kernel; on the CPU its plain twin.

A quantized site (`Int8Site`) takes the place of an nn.Conv2d or
nn.Linear; `ops.nn.conv2d` / `ops.nn.linear` dispatch on it, so the
models' forwards are the same for float and int8. In torch layout the
output channel is axis 0 for a conv (OIHW) and a Linear (out, in) alike:
the JAX package's HWIO axis -1 maps onto it.

Static scales come from an eager calibration pass (models/quantize.py): an
armed site records its activation's amax and runs on the dequantized float
weight instead. Every division here is by a tensor on the operand's
device: CUDA's division by a Python scalar multiplies by the reciprocal,
which can move an int8 level at a rounding boundary.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ffrnet_torch.ops.kernels.int8_conv import int8_conv, pack_weight, to_nhwc

QMAX = 127.0
EPS = 1e-12


def _qmax(device) -> torch.Tensor:
    return torch.tensor(QMAX, dtype=torch.float32, device=device)


def quantize_weight(w: torch.Tensor, channel_axis: int = 0):
    """Symmetric per-channel int8 of a float weight -> (q int8, scale fp32
    (C_out,)) with w ~= q * scale broadcast over `channel_axis`."""
    wf = w.detach().float()
    axis = channel_axis % wf.ndim
    amax = wf.abs().amax(dim=[d for d in range(wf.ndim) if d != axis])
    scale = torch.clamp_min(amax, EPS) / _qmax(wf.device)
    shape = [1] * wf.ndim
    shape[axis] = -1
    q = torch.clamp(torch.round(wf / scale.reshape(shape)), -QMAX, QMAX).to(torch.int8)
    return q, scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor, channel_axis: int = 0):
    shape = [1] * q.ndim
    shape[channel_axis % q.ndim] = -1
    return q.float() * scale.reshape(shape)


def quantize_activation(x: torch.Tensor, x_scale=None):
    """Per-tensor int8 of x -> (q int8 in x's shape, scale fp32 0-d):
    dynamic from max|x| without `x_scale`, else static; round half to
    even, clip at +/-127."""
    if x_scale is None:
        lo, hi = torch.aminmax(x.detach())  # max|x| = max(hi, -lo), in one read
        scale = torch.clamp_min(torch.maximum(hi.float(), -lo.float()), EPS) / _qmax(x.device)
    else:
        scale = torch.clamp_min(x_scale.float(), EPS)
    q = x.detach().float() / scale
    q.round_().clamp_(-QMAX, QMAX)
    return q.to(torch.int8), scale


class Int8Site(nn.Module):
    """An int8 conv or Linear site made from an nn.Conv2d or nn.Linear:
    `weight_q` (its layout, int8), `weight_scale` (fp32, per output
    channel), `x_scale` (fp32 0-d once calibrated, else None: dynamic), the
    float `bias` (or None) and `weight_packed`, the kernel's operand
    (`pack_weight`). The scales stay fp32 when the module is cast."""

    _SCALES = ("weight_scale", "x_scale")

    def __init__(self, layer: nn.Module):
        super().__init__()
        q, scale = quantize_weight(layer.weight, 0)
        self.register_buffer("weight_q", q)
        self.register_buffer("weight_scale", scale)
        self.register_buffer("x_scale", None)
        self.register_buffer("bias", None if layer.bias is None else layer.bias.detach().clone())
        self.register_buffer("weight_packed", pack_weight(q), persistent=False)
        self.calibration = None  # a list of amaxes while a calibration pass is armed

    def _apply(self, fn, recurse=True):
        scales = {k: getattr(self, k) for k in self._SCALES if getattr(self, k) is not None}
        super()._apply(fn, recurse)
        for k, v in scales.items():  # device moves apply, casts do not
            setattr(self, k, v.to(getattr(self, k).device))
        return self


def has_int8_sites(module: nn.Module) -> bool:
    return any(isinstance(m, Int8Site) for m in module.modules())


def _record_calibration_amax(x, site: Int8Site) -> bool:
    """If `site` is armed for calibration and has no baked scale, record
    this activation's amax (what the dynamic path would use) and return
    True: the caller then runs the op on the dequantized float weight."""
    if site.calibration is None or site.x_scale is not None:
        return False
    site.calibration.append(float(x.detach().abs().amax().float()))
    return True


def _float_bias(site: Int8Site):
    return None if site.bias is None else site.bias.float()


def conv2d_int8(x, site: Int8Site, *, stride: int = 1, padding: int = 0):
    """Int8 convolution of NCHW x at `site`, in x's dtype."""
    if _record_calibration_amax(x, site):
        y = F.conv2d(x.float(), dequantize_weight(site.weight_q, site.weight_scale),
                     stride=stride, padding=padding)
        if site.bias is not None:
            y = y + site.bias.float().reshape(1, -1, 1, 1)
        return y.to(x.dtype)
    xq, s_x = quantize_activation(x, site.x_scale)
    return int8_conv(to_nhwc(xq), site.weight_packed, s_x * site.weight_scale,
                     _float_bias(site), stride=stride, padding=padding, out_dtype=x.dtype)


def linear_int8(x, site: Int8Site):
    """Int8 Linear of (N, K) x at `site`, in x's dtype."""
    if _record_calibration_amax(x, site):
        y = F.linear(x.float(), dequantize_weight(site.weight_q, site.weight_scale))
        if site.bias is not None:
            y = y + site.bias.float()
        return y.to(x.dtype)
    xq, s_x = quantize_activation(x, site.x_scale)
    y = int8_conv(to_nhwc(xq), site.weight_packed, s_x * site.weight_scale, _float_bias(site),
                  out_dtype=x.dtype)
    return y.reshape(x.shape[0], -1)
