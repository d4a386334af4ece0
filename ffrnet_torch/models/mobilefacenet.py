"""MobileFaceNet, NCHW (ffrnet_tpu/models/mobilefacenet.py).

The reference's depthwise-separable face embedding net
(pretrain/model_ir_se50.py:156-252), present in its API but never on its
main path: conv and depthwise blocks, bottleneck Depth_Wise units with
residuals, a 7x7 depthwise "linear" conv, then flatten, a Linear without
bias to `embedding_size`, BN1d and an L2 normalization without epsilon,
for 112x112 inputs.

Modules and parameters carry the reference's state-dict keys
(`conv1.conv.weight`, `conv1.bn.*`, `conv1.prelu.weight`,
`conv_23.conv.conv.weight`, `conv_3.model.{i}.conv_dw.*`, `linear.weight`,
`bn.*`). The BNs follow `module.training` (`layers.batch_norm_module`):
running statistics in eval mode; in train mode the batch's
(`ops.nn.batch_norm_train`, as the JAX package's apply(training=True)),
with the new running statistics written in place.
"""

from __future__ import annotations

import torch
from torch import nn

from ffrnet_torch.models.layers import batch_norm_module
from ffrnet_torch.ops import nn as ops

# (name, kind, cin, cout, kernel, stride, padding, groups, num_blocks), the
# JAX package's table
_ARCH = [
    ("conv1", "conv", 3, 64, (3, 3), 2, 1, 1, 0),
    ("conv2_dw", "conv", 64, 64, (3, 3), 1, 1, 64, 0),
    ("conv_23", "dw", 64, 64, None, 2, 1, 128, 0),
    ("conv_3", "res", 64, 64, None, 1, 1, 128, 4),
    ("conv_34", "dw", 64, 128, None, 2, 1, 256, 0),
    ("conv_4", "res", 128, 128, None, 1, 1, 256, 6),
    ("conv_45", "dw", 128, 128, None, 2, 1, 512, 0),
    ("conv_5", "res", 128, 128, None, 1, 1, 256, 2),
    ("conv_6_sep", "conv", 128, 512, (1, 1), 1, 0, 1, 0),
    ("conv_6_dw", "linear", 512, 512, (7, 7), 1, 0, 512, 0),
]


class ConvBlock(nn.Module):
    """The reference's Conv_block (conv -> BN -> PReLU) or, with prelu
    False, its Linear_block (conv -> BN)."""

    def __init__(self, cin, cout, kernel=(1, 1), stride=1, padding=0, groups=1, prelu=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout)
        if prelu:
            self.prelu = nn.PReLU(cout)

    def forward(self, x):
        y = batch_norm_module(self.bn, self.conv(x))
        if hasattr(self, "prelu"):
            y = ops.prelu(y, self.prelu.weight, axis=1)
        return y


class DepthWise(nn.Module):
    """The reference's Depth_Wise: 1x1 conv (cin -> groups), 3x3 depthwise
    conv (stride), 1x1 linear projection (groups -> cout) [+ x]."""

    def __init__(self, cin, cout, stride, groups, residual=False):
        super().__init__()
        self.residual = residual
        self.conv = ConvBlock(cin, groups)
        self.conv_dw = ConvBlock(groups, groups, (3, 3), stride, 1, groups=groups)
        self.project = ConvBlock(groups, cout, prelu=False)

    def forward(self, x):
        y = self.project(self.conv_dw(self.conv(x)))
        return y + x if self.residual else y


class Residual(nn.Module):
    def __init__(self, c, num_blocks, groups):
        super().__init__()
        self.model = nn.Sequential(*(DepthWise(c, c, 1, groups, residual=True)
                                     for _ in range(num_blocks)))

    def forward(self, x):
        return self.model(x)


class MobileFaceNet(nn.Module):
    """forward(x (N, 3, 112, 112)) -> L2-normalized (N, embedding_size)."""

    def __init__(self, embedding_size: int = 512):
        super().__init__()
        for name, kind, cin, cout, kernel, stride, pad, groups, nblocks in _ARCH:
            if kind in ("conv", "linear"):
                block = ConvBlock(cin, cout, kernel, stride, pad, groups, prelu=kind == "conv")
            elif kind == "dw":
                block = DepthWise(cin, cout, stride, groups)
            else:
                block = Residual(cin, nblocks, groups)
            self.add_module(name, block)
        self.linear = nn.Linear(512, embedding_size, bias=False)
        self.bn = nn.BatchNorm1d(embedding_size)

    def forward(self, x):
        for name, *_ in _ARCH:
            x = getattr(self, name)(x)
        y = self.linear(x.flatten(1))  # (N, 512, 1, 1) after the 7x7 depthwise conv
        return ops.l2_norm_div(batch_norm_module(self.bn, y), axis=1)


@torch.no_grad()
def init_mobilefacenet(model: MobileFaceNet, generator: torch.Generator) -> None:
    """Random init as ffrnet_tpu.models.mobilefacenet.init: kaiming-uniform
    convs (fan in per group) and Linear, identity BNs, PReLU 0.25."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
            m.weight.copy_(ops.kaiming_uniform(m.weight.shape, fan_in, generator=generator))
        elif isinstance(m, nn.Linear):
            m.weight.copy_(ops.kaiming_uniform(m.weight.shape, m.in_features,
                                               generator=generator))
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm1d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
        elif isinstance(m, nn.PReLU):
            m.weight.fill_(0.25)


def build_mobilefacenet(embedding_size: int = 512, *, generator=None,
                        device="cpu") -> MobileFaceNet:
    """An eval-mode MobileFaceNet on `device`, filled from `generator` (a
    torch.Generator on the CPU), or left for load_state_dict when None."""
    with torch.device("meta"):
        model = MobileFaceNet(embedding_size)
    model = model.to_empty(device="cpu")
    if generator is not None:
        init_mobilefacenet(model, generator)
    return model.to(device).eval()
