"""Block library: NormLayer / ReluLayer / ConvLayer / ResidualBlock, NCHW.

Counterpart of ffrnet_tpu/models/layers.py. The modules' parameter names are
the reference's state-dict keys (ConvLayer children `conv2d`, `norm.norm`,
`relu.func`), so a released RecNet `.pth` loads with `load_state_dict`.
Forward passes use `ffrnet_torch.ops.nn` so that the numerics follow the
JAX package (eval-mode BN with an fp32 rsqrt, for example).

  * ConvLayer = [2x nearest upsample] -> ReflectionPad(k//2) -> conv (stride 2
    iff scale == 'down', bias iff norm in {pixel, none}) -> norm -> relu.
  * ReluLayer: relu / leakyrelu(0.2) / prelu (per channel) / selu / none.
  * NormLayer: bn / in / gn(32) / pixel / layer / none. A bn layer follows
    `module.training`: in train mode it normalizes with the batch's
    statistics (the global batch's inside `ops.nn.batch_stats_group` of a
    data-parallel step) and moves its running stats in place (momentum
    0.1), unless `running_stats_frozen` holds them; in eval mode it uses
    them.
  * ResidualBlock: two ConvLayers plus the identity.

`init_*` functions fill a module as the JAX package's init does (kaiming
normal convs and linears, zero biases, BN weight ~ N(1, 0.02), PReLU 0.25)
from an explicit `torch.Generator`.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ffrnet_torch.ops import nn as ops

NORM_TYPES = ("bn", "in", "gn", "pixel", "layer", "none")
RELU_TYPES = ("relu", "leakyrelu", "prelu", "selu", "none")


class _Affine(nn.Module):
    """Per-channel weight/bias holder for the in/gn/layer norms."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class NormLayer(nn.Module):
    def __init__(self, channels: int, norm_type: str = "bn"):
        super().__init__()
        if norm_type not in NORM_TYPES:
            raise ValueError(f"Norm type {norm_type} not supported.")
        self.norm_type = norm_type
        self.update_stats = True  # train mode: write the new running stats
        if norm_type == "bn":
            self.norm = nn.BatchNorm2d(channels)
        elif norm_type in ("in", "gn", "layer"):
            self.norm = _Affine(channels)

    def forward(self, x):
        t = self.norm_type
        if t == "bn":
            return batch_norm_module(self.norm, x, update_stats=self.update_stats)
        if t == "in":
            return ops.instance_norm(x, self.norm.weight, self.norm.bias)
        if t == "gn":
            return ops.group_norm(x, self.norm.weight, self.norm.bias)
        if t == "pixel":
            return ops.pixel_norm(x)
        if t == "layer":
            return ops.layer_norm(x, self.norm.weight, self.norm.bias)
        return x


def batch_norm_module(m, x, *, update_stats: bool = True):
    """A BatchNorm{1,2}d `m` on x (channels on axis 1), following
    `m.training`: eval mode normalizes with the running stats; train mode
    with the batch's (over `ops.stats_group()`'s ranks), and writes the
    new running stats into `m` unless update_stats is False."""
    if not m.training:
        return ops.batch_norm(x, m.weight, m.bias, m.running_mean, m.running_var)
    y, mean, var = ops.batch_norm_train(x, m.weight, m.bias, m.running_mean,
                                        m.running_var, group=ops.stats_group())
    if update_stats:
        m.running_mean.copy_(mean)
        m.running_var.copy_(var)
    return y


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module):
    """Train-mode BNs inside `module` compute their batch statistics but
    leave their running stats as they are. A checkpointed forward runs
    again in the backward pass; under this context the recompute does not
    move the running stats a second time."""
    norms = [m for m in module.modules() if isinstance(m, NormLayer)]
    saved = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m, u in zip(norms, saved):
            m.update_stats = u


class ReluLayer(nn.Module):
    def __init__(self, channels: int, relu_type: str = "prelu"):
        super().__init__()
        if relu_type not in RELU_TYPES:
            raise ValueError(f"Relu type {relu_type} not supported.")
        self.relu_type = relu_type
        if relu_type == "prelu":
            self.func = nn.PReLU(channels)

    def forward(self, x):
        t = self.relu_type
        if t == "relu":
            return ops.relu(x)
        if t == "leakyrelu":
            return ops.leaky_relu(x, 0.2)
        if t == "prelu":
            return ops.prelu(x, self.func.weight, axis=1)
        if t == "selu":
            return F.selu(x)
        return x


class ConvLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 *, scale: str = "none", norm_type: str = "none",
                 relu_type: str = "none", use_pad: bool = True):
        super().__init__()
        self.kernel_size = kernel_size
        self.scale = scale
        self.use_pad = use_pad
        self.stride = stride = 2 if scale == "down" else 1
        self.conv2d = nn.Conv2d(in_channels, out_channels, kernel_size,
                                stride=stride,
                                bias=norm_type in ("pixel", "none"))
        self.norm = NormLayer(out_channels, norm_type)
        self.relu = ReluLayer(out_channels, relu_type)

    def forward(self, x):
        if self.scale == "up":
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        if self.use_pad:
            x = ops.reflect_pad(x, self.kernel_size // 2)
        y = ops.conv2d(x, self.conv2d, stride=self.stride)  # an int8 site when quantized
        return self.relu(self.norm(y))


class ResidualBlock(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, *,
                 norm_type: str = "none", relu_type: str = "none"):
        super().__init__()
        kw = {"norm_type": norm_type, "relu_type": relu_type}
        self.conv1 = ConvLayer(channels, channels, kernel_size, **kw)
        self.conv2 = ConvLayer(channels, channels, kernel_size, **kw)

    def forward(self, x):
        return self.conv2(self.conv1(x)) + x


@torch.no_grad()
def init_conv_layer(layer: ConvLayer, generator: torch.Generator) -> None:
    w = layer.conv2d.weight
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    w.copy_(ops.kaiming_normal(w.shape, fan_in, generator=generator))
    if layer.conv2d.bias is not None:
        layer.conv2d.bias.zero_()
    init_norm(layer.norm, generator)
    if layer.relu.relu_type == "prelu":
        layer.relu.func.weight.fill_(0.25)


@torch.no_grad()
def init_norm(norm: NormLayer, generator: torch.Generator) -> None:
    if norm.norm_type == "bn":
        m = norm.norm
        m.weight.copy_(1.0 + 0.02 * torch.randn(m.weight.shape,
                                                generator=generator))
        m.bias.zero_()
        m.running_mean.zero_()
        m.running_var.fill_(1.0)
        m.num_batches_tracked.zero_()
    elif norm.norm_type in ("in", "gn", "layer"):
        norm.norm.weight.fill_(1.0)
        norm.norm.bias.zero_()


@torch.no_grad()
def init_linear(lin: nn.Linear, generator: torch.Generator) -> None:
    """Kaiming-normal weight (fan_in), zero bias."""
    lin.weight.copy_(ops.kaiming_normal(lin.weight.shape, lin.in_features,
                                        generator=generator))
    if lin.bias is not None:
        lin.bias.zero_()

