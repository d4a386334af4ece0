"""Hourglass block and additive SE layer of the reference's model zoo, NCHW
(ffrnet_tpu/models/hourglass.py).

  * `HGBlock`: a recursive hourglass of `layers.ConvLayer`s
    (models/recnet.py:145-200 of the reference). At each level, b1 keeps
    the resolution, b2 halves it (stride 2), the level below (or b2_plus at
    level 1) runs on the half map, b3 doubles it back (2x nearest); the
    two branches are added, the doubled one first resized to the kept one
    where an odd side made them differ. `out` closes the block with a
    conv that has a bias and no norm or activation.
  * `SELayer`: the additive gate x + x * sigmoid(fc2(relu(fc1(gap(x)))))
    (models/recnet.py:325-340 of the reference; note the + x, unlike the
    encoder's multiplicative SEModule). The gated term is the se_gating
    operator, so on the card an SELayer call is one launch of that kernel.

Children and parameters carry the JAX tree's names (`b1_{level}`,
`b2_{level}`, `b2_plus_1`, `b3_{level}`, `out`) and the reference's SE
keys (`fc.0.weight`, `fc.2.weight`).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ffrnet_torch.models import layers as L
from ffrnet_torch.ops import nn as ops
from ffrnet_torch.ops.kernels.se_gating import se_gating


class HGBlock(nn.Module):
    """forward(x (N, c_in, H, W)) -> (N, c_out, H, W). The BNs follow
    `module.training` (layers.NormLayer)."""

    def __init__(self, depth: int, c_in: int, c_out: int, *, c_mid: int = 64,
                 norm_type: str = "bn", relu_type: str = "prelu"):
        super().__init__()
        self.depth = depth
        kw = {"norm_type": norm_type, "relu_type": relu_type}
        for level in range(depth, 0, -1):
            c1 = c_in if level == depth else c_mid
            self.add_module(f"b1_{level}", L.ConvLayer(c1, c_mid, 3, **kw))
            self.add_module(f"b2_{level}", L.ConvLayer(c1, c_mid, 3, scale="down", **kw))
            if level == 1:
                self.b2_plus_1 = L.ConvLayer(c_mid, c_mid, 3, **kw)
            self.add_module(f"b3_{level}", L.ConvLayer(c_mid, c_mid, 3, scale="up", **kw))
        self.out = L.ConvLayer(c_mid, c_out, 3)

    def _level(self, level: int, x):
        up1 = getattr(self, f"b1_{level}")(x)
        low1 = getattr(self, f"b2_{level}")(x)
        low2 = self._level(level - 1, low1) if level > 1 else self.b2_plus_1(low1)
        up2 = getattr(self, f"b3_{level}")(low2)
        if up1.shape[2:] != up2.shape[2:]:
            # jax.image.resize's "nearest" samples at half-pixel centres, as
            # "nearest-exact" does ("nearest" takes floor(i * in / out))
            up2 = F.interpolate(up2, size=up1.shape[2:], mode="nearest-exact")
        return up1 + up2

    def forward(self, x):
        return self.out(self._level(self.depth, x))


def init_hgblock(block: HGBlock, generator) -> None:
    """Random init as ffrnet_tpu's init_hgblock: each ConvLayer kaiming-normal
    with zero biases, BN weight ~ N(1, 0.02), PReLU 0.25."""
    for m in block.modules():
        if isinstance(m, L.ConvLayer):
            L.init_conv_layer(m, generator)


class SELayer(nn.Module):
    """forward(x (N, C, H, W)) -> x + se_gating(x, fc.0.weight, fc.2.weight).

    `fc` keeps the reference's Sequential (Linear, ReLU, Linear, Sigmoid) so
    that its weights sit under the reference's keys; the forward takes the
    two weights to the se_gating operator, which pools, gates and scales in
    one call: its plain twin on a CPU tensor, its kernel on a CUDA one. The
    kernel takes float32 or bfloat16 maps whose weights share their type, a
    16-byte aligned map, and (C, H*W) that a cluster of 1, 2, 4 or 8 CTAs
    holds in shared memory with channel slices in multiples of 16 bytes
    (`ops/kernels/se_gating.py::_se_plan`; every IR-SE50 stage, and C=64 on
    7x7): another map raises ValueError on the card, with no fall back to
    the plain ops. In bfloat16 the gate is computed in fp32 and cast to
    bfloat16 before the multiply."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        r = channel // reduction
        self.fc = nn.Sequential(nn.Linear(channel, r, bias=False), nn.ReLU(inplace=True),
                                nn.Linear(r, channel, bias=False), nn.Sigmoid())

    def forward(self, x):
        return x + se_gating(x, self.fc[0].weight, self.fc[2].weight)


def init_se_layer(layer: SELayer, generator) -> None:
    """Random init as ffrnet_tpu's init_se_layer: kaiming-uniform weights
    (a = sqrt(5), PyTorch's Linear default) from `generator`."""
    for lin in (layer.fc[0], layer.fc[2]):
        w = lin.weight
        w.data.copy_(ops.kaiming_uniform(w.shape, lin.in_features, generator=generator))
