"""IR-SE ResNet face encoder (ArcFace-style), NCHW.

Counterpart of ffrnet_tpu/models/irse.py; module and parameter names are the
reference Backbone's state-dict keys (`input_layer.*`, `body.{i}.*`, `bn.*`,
`output_layer.*`):

  stem:   Conv3x3(3->64, s1, zero-pad 1, no bias) -> BN -> PReLU(64)
  body:   bottleneck units for num_layers in {50, 100, 152}; each unit is
          BN -> Conv3x3 -> PReLU -> Conv3x3(stride) -> BN [-> SE(r=16)]
          plus a shortcut (stride slice when in == depth, else
          Conv1x1(stride) + BN)
  heads:  featmap = BN2d(body)                                (N, 512, 7, 7)
          embed   = l2_norm(BN1d(Linear(Flatten(BN2d(body)))))  (N, 512)

The encoder runs in inference mode only (BN running stats, dropout off).
Every SE gate goes through the `se_gating` wrapper, 24 per IR-SE50 forward.
The body convs and the output Linear go through `ops.conv2d` / `ops.linear`,
which run the int8 product where models/quantize.py put an int8 site.
Flatten of an NCHW map is already the reference's C-major order.
"""

from __future__ import annotations

import re
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ffrnet_torch.ops import nn as ops
from ffrnet_torch.ops.kernels.se_gating import se_gating

# (in_channel, depth, num_units) per stage; every stage opens with stride 2.
_BLOCK_SPECS = {
    50: [(64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)],
    100: [(64, 64, 3), (64, 128, 13), (128, 256, 30), (256, 512, 3)],
    152: [(64, 64, 3), (64, 128, 8), (128, 256, 36), (256, 512, 3)],
}

EMBED_DIM = 512
FEAT_HW = 7


def unit_configs(num_layers: int) -> List[Tuple[int, int, int]]:
    """Flat list of (in_channel, depth, stride) over all bottleneck units."""
    units = []
    for in_ch, depth, num in _BLOCK_SPECS[num_layers]:
        units.append((in_ch, depth, 2))
        units.extend((depth, depth, 1) for _ in range(num - 1))
    return units


def _bn(m: nn.Module, x):
    return ops.batch_norm(x, m.weight, m.bias, m.running_mean, m.running_var)


class SEModule(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1, bias=False)

    def forward(self, x):
        return se_gating(x, self.fc1.weight.flatten(1), self.fc2.weight.flatten(1))


class BottleneckIR(nn.Module):
    def __init__(self, in_channel: int, depth: int, stride: int, mode: str):
        super().__init__()
        self.stride = stride
        if in_channel == depth:
            self.shortcut_layer = None  # MaxPool2d(1, stride): a stride slice
        else:
            self.shortcut_layer = nn.Sequential(
                nn.Conv2d(in_channel, depth, 1, stride, bias=False),
                nn.BatchNorm2d(depth))
        layers = [nn.BatchNorm2d(in_channel),
                  nn.Conv2d(in_channel, depth, 3, 1, 1, bias=False),
                  nn.PReLU(depth),
                  nn.Conv2d(depth, depth, 3, stride, 1, bias=False),
                  nn.BatchNorm2d(depth)]
        if mode == "ir_se":
            layers.append(SEModule(depth))
        self.res_layer = nn.Sequential(*layers)

    def forward(self, x):
        if self.shortcut_layer is None:
            sc = ops.stride_pool(x, self.stride)
        else:
            conv, bn = self.shortcut_layer
            sc = _bn(bn, ops.conv2d(x, conv, stride=self.stride))
        r = self.res_layer
        y = _bn(r[0], x)
        y = ops.conv2d(y, r[1], stride=1, padding=1)
        y = ops.prelu(y, r[2].weight, axis=1)
        y = ops.conv2d(y, r[3], stride=self.stride, padding=1)
        y = _bn(r[4], y)
        if len(r) > 5:
            y = r[5](y)
        return y + sc


class Backbone(nn.Module):
    """forward(x (N, 3, 112, 112) in [-1, 1], BGR) -> (featmap (N, 512, 7, 7),
    embed (N, 512) L2-normalized)."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se",
                 drop_ratio: float = 0.6):
        super().__init__()
        if num_layers not in _BLOCK_SPECS or mode not in ("ir", "ir_se"):
            raise ValueError(f"unsupported IR-SE config: num_layers="
                             f"{num_layers}, mode={mode!r}")
        self.num_layers, self.mode = num_layers, mode
        self.input_layer = nn.Sequential(
            nn.Conv2d(3, 64, 3, 1, 1, bias=False), nn.BatchNorm2d(64),
            nn.PReLU(64))
        self.body = nn.ModuleList(
            BottleneckIR(i, d, s, mode) for i, d, s in unit_configs(num_layers))
        self.bn = nn.BatchNorm2d(EMBED_DIM)
        self.output_layer = nn.Sequential(
            nn.BatchNorm2d(EMBED_DIM), nn.Dropout(drop_ratio), nn.Flatten(),
            nn.Linear(EMBED_DIM * FEAT_HW * FEAT_HW, EMBED_DIM),
            nn.BatchNorm1d(EMBED_DIM))

    def forward(self, x):
        conv, bn, prelu = self.input_layer
        w_in = conv.weight
        if w_in.shape[1] > x.shape[1]:
            if x.shape[1] != 3:
                # only the documented 3-channel input is padded; anything
                # else (a grayscale batch) is a caller bug
                raise ValueError(
                    f"channel-padded stem expects 3-channel input, got "
                    f"{x.shape[1]} channels (weight expects {w_in.shape[1]})")
            # channel-padded stem: zero channels contribute exactly 0
            x = F.pad(x, (0, 0, 0, 0, 0, w_in.shape[1] - x.shape[1]))
        y = F.conv2d(x, w_in, conv.bias, stride=1, padding=1)
        y = ops.prelu(_bn(bn, y), prelu.weight, axis=1)
        for unit in self.body:
            y = unit(y)
        featmap = _bn(self.bn, y)
        out = self.output_layer
        h = _bn(out[0], y).flatten(1)  # dropout is off in inference
        h = ops.linear(h, out[3])
        h = _bn(out[4], h)
        return featmap, ops.l2_norm_div(h, axis=1)


def check_state_dict(sd, num_layers: int = 50, mode: str = "ir_se") -> None:
    """Fail fast when a Backbone state dict does not fit (num_layers, mode).

    A 100-layer dict under num_layers=50, or an ir_se dict under mode='ir',
    would otherwise fail deep inside load_state_dict, or (for a hand-built
    module) give plausible but wrong embeddings.
    """
    units = unit_configs(num_layers)
    idx = {int(m.group(1)) for k in sd
           if (m := re.match(r"body\.(\d+)\.", k))}
    if len(idx) != len(units):
        raise ValueError(
            f"state dict has {len(idx)} residual units but num_layers="
            f"{num_layers} expects {len(units)} — pass the num_layers the "
            "weights were made with")
    has_se = "body.0.res_layer.5.fc1.weight" in sd
    if (mode == "ir_se") != has_se:
        raise ValueError(
            f"mode={mode!r} does not match the state dict (which "
            f"{'has' if has_se else 'lacks'} SE blocks)")


@torch.no_grad()
def init_backbone(model: Backbone, generator: torch.Generator) -> None:
    """Random init as ffrnet_tpu.models.irse.init: kaiming-uniform convs,
    SE and Linear weights, a torch-default Linear bias, identity BNs, PReLU
    0.25."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
            m.weight.copy_(ops.kaiming_uniform(m.weight.shape, fan_in,
                                               generator=generator))
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm1d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
        elif isinstance(m, nn.PReLU):
            m.weight.fill_(0.25)
        elif isinstance(m, nn.Linear):
            m.weight.copy_(ops.kaiming_uniform(m.weight.shape, m.in_features,
                                               generator=generator))
            m.bias.copy_(ops.bias_uniform(m.bias.shape, m.in_features,
                                          generator=generator))


def build_backbone(num_layers: int = 50, mode: str = "ir_se", *,
                   generator=None, device="cpu") -> Backbone:
    """An eval-mode Backbone on `device`, filled from `generator` (a
    torch.Generator on the CPU), or left for load_state_dict when None."""
    with torch.device("meta"):
        model = Backbone(num_layers, mode)
    model = model.to_empty(device="cpu")
    if generator is not None:
        init_backbone(model, generator)
    return model.to(device).eval()
