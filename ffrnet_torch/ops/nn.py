"""Primitive ops, NCHW, with the JAX package's numerics (ffrnet_tpu/ops/nn.py).

Layout: feature maps are NCHW and conv weights OIHW, so convolutions are
plain `F.conv2d`. Channel-wise ops take the channel axis explicitly.
Epsilons and rounding points follow `ffrnet_tpu.ops.nn`, which in turn
follows the PyTorch reference modules.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Initializers (torch.Generator driven, PyTorch-equivalent)
# ---------------------------------------------------------------------------


def kaiming_normal(shape, fan_in, *, generator, dtype=torch.float32):
    """He-normal with gain for a=0 (torch.nn.init.kaiming_normal_, fan_in)."""
    std = math.sqrt(2.0 / fan_in)
    return std * torch.randn(shape, generator=generator, dtype=dtype)


def kaiming_uniform(shape, fan_in, *, generator, a=math.sqrt(5.0),
                    dtype=torch.float32):
    """Torch's default Conv/Linear weight init (kaiming_uniform, a=sqrt(5))."""
    gain = math.sqrt(2.0 / (1.0 + a * a))
    bound = gain * math.sqrt(3.0 / fan_in)
    return (torch.rand(shape, generator=generator, dtype=dtype) * 2 - 1) * bound


def xavier_uniform(shape, fan_in, fan_out, *, generator, dtype=torch.float32):
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator, dtype=dtype) * 2 - 1) * a


def bias_uniform(shape, fan_in, *, generator, dtype=torch.float32):
    """Torch's default bias init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return (torch.rand(shape, generator=generator, dtype=dtype) * 2 - 1) * bound


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


def _chan_shape(x, axis):
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    return shape


def batch_norm(x, scale, bias, running_mean, running_var, *, axis: int = 1,
               eps: float = 1e-5):
    """Eval-mode BatchNorm: rsqrt(var + eps) in fp32, cast to x's dtype,
    then the affine (ffrnet_tpu/ops/nn.py:150-151)."""
    shape = _chan_shape(x, axis)
    inv = torch.rsqrt(running_var.float() + eps).to(x.dtype)
    a = (inv * scale.to(x.dtype)).reshape(shape)
    return (x - running_mean.to(x.dtype).reshape(shape)) * a \
        + bias.to(x.dtype).reshape(shape)


def batch_norm_train(x, scale, bias, running_mean, running_var, *, axis: int = 1,
                     momentum: float = 0.1, eps: float = 1e-5):
    """Train-mode BatchNorm (ffrnet_tpu/ops/nn.py:114-150) -> (y, new_mean,
    new_var). The batch statistics are taken in fp32 whatever x's type; y
    is normalized with the biased variance, and the running variance moves
    toward the unbiased one with `momentum`. The new running stats are
    detached and keep the running stats' dtype; `num_batches_tracked` plays
    no part (never the cumulative-average mode)."""
    shape = _chan_shape(x, axis)
    dims = tuple(d for d in range(x.ndim) if d != axis)
    xf = x.float()
    mean = xf.mean(dim=dims)
    var = (xf - mean.reshape(shape)).square().mean(dim=dims)
    n = x.numel() // x.shape[axis]
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        new_mean = ((1 - momentum) * running_mean.float()
                    + momentum * mean).to(running_mean.dtype)
        new_var = ((1 - momentum) * running_var.float()
                   + momentum * unbiased).to(running_var.dtype)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    y = (x - mean.to(x.dtype).reshape(shape)) * (inv * scale.to(x.dtype)).reshape(shape) \
        + bias.to(x.dtype).reshape(shape)
    return y, new_mean, new_var


def instance_norm(x, scale, bias, *, eps: float = 1e-5):
    """InstanceNorm2d(affine=True) on NCHW (per-sample, per-channel)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * scale.reshape(1, -1, 1, 1) + bias.reshape(1, -1, 1, 1)


def group_norm(x, scale, bias, *, groups: int = 32, eps: float = 1e-5):
    """GroupNorm on NCHW."""
    n, c, h, w = x.shape
    xg = x.reshape(n, groups, c // groups, h, w)
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = xg.var(dim=(2, 3, 4), keepdim=True, unbiased=False)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(n, c, h, w)
    return y * scale.reshape(1, -1, 1, 1) + bias.reshape(1, -1, 1, 1)


def pixel_norm(x, *, eps: float = 1e-12):
    """F.normalize(p=2) over the channel axis (dim 1 in NCHW)."""
    return l2_normalize(x, axis=1, eps=eps)


def layer_norm(x, scale, bias, *, eps: float = 1e-5):
    """Normalizes over the channel axis of NCHW (the JAX version's last axis
    of NHWC), with a per-channel affine."""
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * scale.reshape(1, -1, 1, 1) + bias.reshape(1, -1, 1, 1)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def prelu(x, slope, *, axis: int):
    """PReLU with a per-channel slope along `axis` (torch: dim 1)."""
    shape = [1] * x.ndim
    shape[axis] = slope.shape[0]
    a = slope.reshape(shape).to(x.dtype)
    return torch.where(x >= 0, x, a * x)


def leaky_relu(x, negative_slope=0.2):
    return torch.where(x >= 0, x, negative_slope * x)


def relu(x):
    return torch.clamp_min(x, 0)


# ---------------------------------------------------------------------------
# Pooling / padding / norms
# ---------------------------------------------------------------------------


def reflect_pad(x, pad):
    """ReflectionPad2d on NCHW."""
    if pad == 0:
        return x
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def stride_pool(x, stride):
    """MaxPool2d(kernel_size=1, stride=s): pure stride slicing (NCHW)."""
    if stride == 1:
        return x
    return x[:, :, ::stride, ::stride]


def global_avg_pool(x):
    """AdaptiveAvgPool2d(1) on NCHW -> (N, C)."""
    return x.mean(dim=(2, 3))


def l2_normalize(x, axis=-1, eps: float = 1e-12):
    """F.normalize semantics: x / max(||x||, eps)."""
    norm = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    return x / torch.clamp_min(norm, eps)


def l2_norm_div(x, axis=-1):
    """The encoder's final `l2_norm`: x / ||x|| with no epsilon."""
    norm = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    return x / norm


def tree_cast_floats(tree: dict, dtype):
    """A dict of tensors with its floating tensors cast to `dtype` (the
    mixed-precision compute copy, ffrnet_tpu/ops/nn.py:265); integer
    tensors pass through, and so does the whole dict when dtype is None.
    The casts are differentiable, so gradients reach the originals."""
    if dtype is None:
        return tree
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tree.items()}


def images_to_unit_range(x):
    """uint8 -> float32 in [-1, 1] as (x/255 - 0.5)/0.5 (ToTensor +
    Normalize(0.5, 0.5)); float inputs pass through unchanged.

    The divisor is a tensor on x's device: PyTorch's CUDA division by a
    Python scalar multiplies by the reciprocal, up to 1 ulp away from the
    IEEE division that the host loaders and the JAX package compute."""
    if x.dtype == torch.uint8:
        d = torch.tensor(255.0, dtype=torch.float32, device=x.device)
        return (x.float() / d - 0.5) / 0.5
    return x
