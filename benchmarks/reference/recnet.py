"""Plain RecNet (FFR-Net, arXiv 2202.07358; haoosz/FFR-Net models/recnet.py),
NCHW, as a dict of tensors under the original checkpoint's keys.

  ss_space, ss_channel   cosine Grams of the 7x7x512 map's positions and
                         channels (N, 49, 49), (N, 512, 512)
  M_space                Conv4Space(cat(featmap, ss_space as 49 maps)), a
                         sigmoid, (N, 49, 49)
  M_channel              Conv4Channel(cat(X, ss_channel)): three
                         Linear -> PReLU(512) -> Linear blocks and a sigmoid
  feat_space = X M_space, feat_channel = M_channel X, X = (N, 512, 49)
  feat_channel_m         ChannelFlipMerge(cat(width-flipped, feat_channel))
  feat_new               Conv4Merge(cat(feat_space, feat_channel_m, featmap))
  feat_new_v             7x7 mean of feat_new
  training               CosFace logits s (cos - m onehot) of feat_new_v

The channel attention is computed as written, with the (N, 512, 512) Gram
and M_channel materialized. A ConvLayer is reflect-pad 1 -> conv3x3 (no
bias) -> BN -> PReLU; a ResidualBlock two of them plus the identity.
BNs use running statistics in eval and the batch's in training (biased
variance to normalize; the running variance moves toward the unbiased
one, momentum 0.1).

`init_params(seed, num_classes, device)` draws the weights on `device`
from `seed` (`weights.draw`): each ConvLayer's conv kaiming-normal, each
Linear kaiming-normal with a zero bias, the classifier xavier-uniform, as
the port's `init_recnet` makes them. Every BN and PReLU is drawn per
channel, not left near its init: BN weight and running variance in
[0.5, 1.5], bias and running mean in +-0.05, PReLU slopes in
[0.05, 0.45], so that the eval BNs and each slope's channel count.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmarks.reference import weights

C, SIDE, HW = 512, 7, 49
BN_EPS = 1e-5
# (key, in, out) of every ConvLayer, in module order
CONV_LAYERS = (
    [("Conv4Space.0", C + HW, 256), ("Conv4Space.1.conv1", 256, 256),
     ("Conv4Space.1.conv2", 256, 256), ("Conv4Space.2", 256, 128),
     ("Conv4Space.3.conv1", 128, 128), ("Conv4Space.3.conv2", 128, 128),
     ("Conv4Space.4", 128, HW), ("Conv4Space.5.conv1", HW, HW),
     ("Conv4Space.5.conv2", HW, HW)])
CHANNEL_LINEARS = [("Conv4Channel.0", C + HW, 32), ("Conv4Channel.2", 32, C),
                   ("Conv4Channel.3", C, 32), ("Conv4Channel.5", 32, C),
                   ("Conv4Channel.6", C, 32), ("Conv4Channel.8", 32, C)]
CHANNEL_PRELUS = ("Conv4Channel.1", "Conv4Channel.4", "Conv4Channel.7")
MERGE_LAYERS = [("ChannelFlipMerge.0", 2 * C, C), ("ChannelFlipMerge.1.conv1", C, C),
                ("ChannelFlipMerge.1.conv2", C, C), ("Conv4Merge.0", 3 * C, C),
                ("Conv4Merge.1.conv1", C, C), ("Conv4Merge.1.conv2", C, C)]


def _const(key, c, value):
    return (key, (c,), "const", value, 0.0)


def _uniform(key, c, base, scale):
    return (key, (c,), "uniform", base, scale)


def _prelu(key, c):
    return _uniform(key, c, 0.25, 0.2)


def _conv_layer(key, cin, cout):
    n = f"{key}.norm.norm"
    return [(f"{key}.conv2d.weight", (cout, cin, 3, 3), "normal", 0.0,
             math.sqrt(2.0 / (cin * 9))),
            _uniform(f"{n}.weight", cout, 1.0, 0.5), _uniform(f"{n}.bias", cout, 0.0, 0.05),
            _uniform(f"{n}.running_mean", cout, 0.0, 0.05),
            _uniform(f"{n}.running_var", cout, 1.0, 0.5), _prelu(f"{key}.relu.func.weight", cout)]


def layout(num_classes: int = 10575) -> list:
    """RecNet's leaves as `weights.draw` takes them."""
    out = []
    for key, cin, cout in CONV_LAYERS:
        out += _conv_layer(key, cin, cout)
    for key, cin, cout in CHANNEL_LINEARS:
        out += [(f"{key}.weight", (cout, cin), "normal", 0.0, math.sqrt(2.0 / cin)),
                _const(f"{key}.bias", cout, 0.0)]
    out += [_prelu(f"{key}.func.weight", C) for key in CHANNEL_PRELUS]
    for key, cin, cout in MERGE_LAYERS:
        out += _conv_layer(key, cin, cout)
    a = math.sqrt(6.0 / (C + num_classes))
    return out + [("classifier.weight", (num_classes, C), "uniform", 0.0, a)]


def init_params(seed: int, num_classes: int = 10575, device="cpu") -> dict:
    """RecNet's float32 weights on `device`, from `seed`."""
    return weights.draw(layout(num_classes), seed, device)


BUFFER_SUFFIXES = (".running_mean", ".running_var")


def is_buffer(key: str) -> bool:
    return key.endswith(BUFFER_SUFFIXES)


def _conv_layer_apply(p, key, x, num, train):
    x = F.pad(x, (1, 1, 1, 1), mode="reflect")
    y = num.conv(f"{key}.conv2d", x, p[f"{key}.conv2d.weight"])
    n = f"{key}.norm.norm"
    y = F.batch_norm(y, p[f"{n}.running_mean"], p[f"{n}.running_var"], p[f"{n}.weight"],
                     p[f"{n}.bias"], train, 0.1, BN_EPS)
    return F.prelu(y, p[f"{key}.relu.func.weight"])


def _block(p, key, x, num, train):
    y = _conv_layer_apply(p, f"{key}.conv1", x, num, train)
    return _conv_layer_apply(p, f"{key}.conv2", y, num, train) + x


def cosine_gram(rows, eps=1e-12):
    """(N, R, D) -> (N, R, R) cosines between rows."""
    r = rows / torch.sqrt(torch.sum(rows * rows, dim=2, keepdim=True)).clamp_min(eps)
    return r @ r.transpose(1, 2)


def forward(p: dict, featmap, num, *, train: bool = False):
    """featmap (N, 512, 7, 7) -> dict of feat_new_v (N, 512), feat_space,
    feat_channel_m (N, 512, 7, 7). In training the BNs take the batch's
    statistics and move the running statistics of `p` in place."""
    n = featmap.shape[0]
    flat = featmap.reshape(n, C, HW)
    ss_space = cosine_gram(flat.transpose(1, 2))
    ss_channel = cosine_gram(flat)

    y = torch.cat([featmap, ss_space.reshape(n, HW, SIDE, SIDE)], dim=1)
    y = _conv_layer_apply(p, "Conv4Space.0", y, num, train)
    y = _block(p, "Conv4Space.1", y, num, train)
    y = _conv_layer_apply(p, "Conv4Space.2", y, num, train)
    y = _block(p, "Conv4Space.3", y, num, train)
    y = _conv_layer_apply(p, "Conv4Space.4", y, num, train)
    y = _block(p, "Conv4Space.5", y, num, train)
    m_space = torch.sigmoid(y).reshape(n, HW, HW)

    h = torch.cat([flat, ss_channel], dim=2)
    for i in range(3):
        a, b = CHANNEL_LINEARS[2 * i][0], CHANNEL_LINEARS[2 * i + 1][0]
        h = num.linear(a, h, p[f"{a}.weight"], p[f"{a}.bias"])
        h = F.prelu(h, p[f"{CHANNEL_PRELUS[i]}.func.weight"])
        h = num.linear(b, h, p[f"{b}.weight"], p[f"{b}.bias"])
    m_channel = torch.sigmoid(h)

    feat_space = (flat @ m_space).reshape(n, C, SIDE, SIDE)
    feat_channel = (m_channel @ flat).reshape(n, C, SIDE, SIDE)
    y = torch.cat([torch.flip(feat_channel, dims=[3]), feat_channel], dim=1)
    y = _conv_layer_apply(p, "ChannelFlipMerge.0", y, num, train)
    feat_channel_m = _block(p, "ChannelFlipMerge.1", y, num, train)
    y = torch.cat([feat_space, feat_channel_m, featmap], dim=1)
    y = _conv_layer_apply(p, "Conv4Merge.0", y, num, train)
    feat_new = _block(p, "Conv4Merge.1", y, num, train)
    return {"feat_new_v": feat_new.mean(dim=(2, 3)), "feat_space": feat_space,
            "feat_channel_m": feat_channel_m}


def cosface_logits(w, feat, label, *, s=30.0, m=0.40, eps=1e-12):
    """CosFace (AddMarginProduct): s (cos - m onehot) over every class."""
    fn = feat / torch.sqrt(torch.sum(feat * feat, dim=1, keepdim=True)).clamp_min(eps)
    wn = w / torch.sqrt(torch.sum(w * w, dim=1, keepdim=True)).clamp_min(eps)
    cos = fn @ wn.T
    onehot = F.one_hot(label, w.shape[0]).to(cos.dtype)
    return s * (cos - m * onehot)
