"""BN folding and the channel-padded stem for the frozen encoder
(counterparts of ffrnet_tpu/models/optimize.py::fold_backbone_bn and
::pad_stem_input_channels).

    y = BN(conv(x)) == conv'(x) + b',  w'[o] = w[o] * g_o,
    b'_o = beta_o - mean_o * g_o,      g = gamma / sqrt(var + eps)

Folded convs gain a bias and the folded BNs become identities (weight 1,
bias 0, mean 0, var 1 - eps). The stem conv, every projection shortcut,
each unit's second conv (its first is followed by PReLU and cannot fold)
and the head's Linear -> BN1d fold; the other BNs have no conv before them.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from ffrnet_torch.models.irse import Backbone

_EPS = 1e-5


def _identity(bn) -> None:
    bn.weight.fill_(1.0)
    bn.bias.zero_()
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0 - _EPS)


def _fold_conv(conv: nn.Conv2d, bn) -> None:
    g = bn.weight / torch.sqrt(bn.running_var + _EPS)
    conv.weight.copy_(conv.weight * g.reshape(-1, 1, 1, 1))
    conv.bias = nn.Parameter(bn.bias - bn.running_mean * g)
    _identity(bn)


@torch.no_grad()
def fold_backbone_bn(model: Backbone) -> Backbone:
    """A copy of `model` with every conv -> BN / linear -> BN1d pair folded."""
    model = copy.deepcopy(model)
    _fold_conv(model.input_layer[0], model.input_layer[1])
    for unit in model.body:
        if unit.shortcut_layer is not None:
            _fold_conv(unit.shortcut_layer[0], unit.shortcut_layer[1])
        _fold_conv(unit.res_layer[3], unit.res_layer[4])
    lin, bn = model.output_layer[3], model.output_layer[4]
    g = bn.weight / torch.sqrt(bn.running_var + _EPS)
    lin.weight.copy_(lin.weight * g[:, None])
    lin.bias.copy_((lin.bias - bn.running_mean) * g + bn.bias)
    _identity(bn)
    return model


@torch.no_grad()
def pad_stem_input_channels(model: Backbone, to: int = 8) -> Backbone:
    """A copy of `model` whose stem conv weight is zero-padded on its input
    channels from 3 to `to`: (64, to, 3, 3), `in_channels` = `to`.

    Zero channels add exactly 0 to each product, and `Backbone.forward`
    pads a 3-channel input to the weight's width, so the copy is a drop-in
    on raw and BN-folded encoders (the bias, if folded, is kept). It
    probes whether a C=3 convolution starves the tensor cores
    (`tools/bench_stages.py --stem_duel 1`). A stem already `to` wide or
    wider is left as it is. The caller's model is never modified.
    """
    model = copy.deepcopy(model)
    conv = model.input_layer[0]
    cin = conv.weight.shape[1]
    if cin < to:
        conv.weight = nn.Parameter(F.pad(conv.weight, (0, 0, 0, 0, 0, to - cin)),
                                   requires_grad=conv.weight.requires_grad)
        conv.in_channels = to
    return model
