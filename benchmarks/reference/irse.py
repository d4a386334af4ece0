"""Plain IR-SE50 (InsightFace, arXiv 1801.07698; the FFR-Net encoder), NCHW,
as a dict of tensors under the original checkpoint's keys.

  stem:  conv3x3(3->64, no bias) -> BN -> PReLU
  unit:  shortcut (stride slice when in == depth, else conv1x1(stride) + BN)
         + BN -> conv3x3 -> PReLU -> conv3x3(stride) -> BN -> SE(r=16)
  out:   featmap = BN(body);  embed = l2(BN1d(Linear(flatten(BN(body)))))

`init_params(seed, device)` draws the weights on `device` from `seed`
(`weights.draw`, one uniform draw for every leaf): the convs (SE included)
and the Linear kaiming-uniform with a = sqrt(5), the Linear's bias uniform
in +-1/sqrt(fan_in), as PyTorch's own defaults and the port's
`init_backbone` make them. Every BN and PReLU is drawn per channel, not
left at its init (which would make a BN all but the identity and a slope
one number): BN weight and running variance in [0.5, 1.5], bias and
running mean in +-0.02 (the order of the activations at this init), PReLU
slopes in [0.05, 0.45]. So a BN dropped or folded wrongly, or a slope read
from the wrong channel, moves the embeddings.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmarks.reference import weights

BLOCKS = [(64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)]
BN_EPS = 1e-5


def units():
    out = []
    for in_ch, depth, num in BLOCKS:
        out.append((in_ch, depth, 2))
        out.extend((depth, depth, 1) for _ in range(num - 1))
    return out


def _kaiming_uniform(key, shape, fan_in):
    a = math.sqrt(5.0)
    gain = math.sqrt(2.0 / (1.0 + a * a))
    return (key, shape, "uniform", 0.0, gain * math.sqrt(3.0 / fan_in))


def _conv(key, shape):
    return [_kaiming_uniform(key, shape, shape[1] * shape[2] * shape[3])]


def _uniform(key, c, base, scale):
    return (key, (c,), "uniform", base, scale)


def _bn(key, c):
    return [_uniform(f"{key}.weight", c, 1.0, 0.5), _uniform(f"{key}.bias", c, 0.0, 0.02),
            _uniform(f"{key}.running_mean", c, 0.0, 0.02),
            _uniform(f"{key}.running_var", c, 1.0, 0.5)]


def _prelu(key, c):
    return _uniform(key, c, 0.25, 0.2)


def layout() -> list:
    """The encoder's leaves as `weights.draw` takes them."""
    out = _conv("input_layer.0.weight", (64, 3, 3, 3)) + _bn("input_layer.1", 64)
    out.append(_prelu("input_layer.2.weight", 64))
    for i, (cin, depth, _) in enumerate(units()):
        u = f"body.{i}"
        if cin != depth:
            out += _conv(f"{u}.shortcut_layer.0.weight", (depth, cin, 1, 1))
            out += _bn(f"{u}.shortcut_layer.1", depth)
        out += _bn(f"{u}.res_layer.0", cin)
        out += _conv(f"{u}.res_layer.1.weight", (depth, cin, 3, 3))
        out.append(_prelu(f"{u}.res_layer.2.weight", depth))
        out += _conv(f"{u}.res_layer.3.weight", (depth, depth, 3, 3))
        out += _bn(f"{u}.res_layer.4", depth)
        out += _conv(f"{u}.res_layer.5.fc1.weight", (depth // 16, depth, 1, 1))
        out += _conv(f"{u}.res_layer.5.fc2.weight", (depth, depth // 16, 1, 1))
    out += _bn("bn", 512) + _bn("output_layer.0", 512)
    k = 512 * 7 * 7
    out.append(_kaiming_uniform("output_layer.3.weight", (512, k), k))
    out.append(("output_layer.3.bias", (512,), "uniform", 0.0, 1.0 / math.sqrt(k)))
    return out + _bn("output_layer.4", 512)


def init_params(seed: int, device="cpu") -> dict:
    """The encoder's float32 weights on `device`, from `seed`."""
    return weights.draw(layout(), seed, device)


@torch.no_grad()
def fold_bn(p: dict) -> dict:
    """A copy with every conv -> BN (and Linear -> BN1d) pair folded into
    the conv's weight and a bias, those BNs removed: the stem, every
    projection shortcut, each unit's second conv and the head's Linear."""
    p = dict(p)

    def fold(w_key, bn, b_key, bias=None):
        g = p[f"{bn}.weight"] / torch.sqrt(p[f"{bn}.running_var"] + BN_EPS)
        shape = (-1,) + (1,) * (p[w_key].ndim - 1)
        p[w_key] = p[w_key] * g.reshape(shape)
        base = 0.0 if bias is None else bias
        p[b_key] = (base - p[f"{bn}.running_mean"]) * g + p[f"{bn}.bias"]
        for s in ("weight", "bias", "running_mean", "running_var"):
            del p[f"{bn}.{s}"]

    fold("input_layer.0.weight", "input_layer.1", "input_layer.0.bias")
    for i, (cin, depth, _) in enumerate(units()):
        u = f"body.{i}"
        if cin != depth:
            fold(f"{u}.shortcut_layer.0.weight", f"{u}.shortcut_layer.1",
                 f"{u}.shortcut_layer.0.bias")
        fold(f"{u}.res_layer.3.weight", f"{u}.res_layer.4", f"{u}.res_layer.3.bias")
    fold("output_layer.3.weight", "output_layer.4", "output_layer.3.bias",
         bias=p["output_layer.3.bias"])
    return p


def _bn_apply(p, key, x):
    if f"{key}.weight" not in p:  # folded away
        return x
    return F.batch_norm(x, p[f"{key}.running_mean"], p[f"{key}.running_var"],
                        p[f"{key}.weight"], p[f"{key}.bias"], False, 0.0, BN_EPS)


def forward(p: dict, x, num):
    """x (N, 3, 112, 112) BGR in [-1, 1] -> (featmap (N, 512, 7, 7), embed
    (N, 512) L2-normalized). `num`: a `numerics.Numerics`."""
    y = num.conv("input_layer.0", x, p["input_layer.0.weight"], p.get("input_layer.0.bias"),
                 padding=1)
    y = F.prelu(_bn_apply(p, "input_layer.1", y), p["input_layer.2.weight"])
    for i, (cin, depth, stride) in enumerate(units()):
        u = f"body.{i}"
        if cin == depth:
            sc = y[:, :, ::stride, ::stride]
        else:
            sc = num.conv(f"{u}.shortcut_layer.0", y, p[f"{u}.shortcut_layer.0.weight"],
                          p.get(f"{u}.shortcut_layer.0.bias"), stride=stride)
            sc = _bn_apply(p, f"{u}.shortcut_layer.1", sc)
        r = _bn_apply(p, f"{u}.res_layer.0", y)
        r = num.conv(f"{u}.res_layer.1", r, p[f"{u}.res_layer.1.weight"], padding=1)
        r = F.prelu(r, p[f"{u}.res_layer.2.weight"])
        r = num.conv(f"{u}.res_layer.3", r, p[f"{u}.res_layer.3.weight"],
                     p.get(f"{u}.res_layer.3.bias"), stride=stride, padding=1)
        r = _bn_apply(p, f"{u}.res_layer.4", r)
        pooled = r.mean(dim=(2, 3))
        hid = torch.relu(pooled @ p[f"{u}.res_layer.5.fc1.weight"].flatten(1).T)
        gate = torch.sigmoid(hid @ p[f"{u}.res_layer.5.fc2.weight"].flatten(1).T)
        y = r * gate[:, :, None, None] + sc
    featmap = _bn_apply(p, "bn", y)
    h = _bn_apply(p, "output_layer.0", y).flatten(1)
    h = num.linear("output_layer.3", h, p["output_layer.3.weight"], p["output_layer.3.bias"])
    h = _bn_apply(p, "output_layer.4", h)
    return featmap, h / torch.sqrt(torch.sum(h * h, dim=1, keepdim=True))


INT8_SITES = frozenset(
    [f"body.{i}.res_layer.{j}" for i in range(24) for j in (1, 3)]
    + [f"body.{i}.shortcut_layer.0" for i, (cin, depth, _) in enumerate(units())
       if cin != depth]
    + ["output_layer.3"])
