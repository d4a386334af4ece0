"""Model operations of IR-SE50 and RecNet, counted from shapes.

A copy of `ffrnet_torch/tools/bench_stages.py::stage_flops` and
`_unit_flops` (the encoder by stage), kept here so that a change to the
program cannot change the yardstick, and RecNet's inference and training
operations counted the same way: 2 operations a multiply-add, the
mathematical model as published (the materialized channel Gram and
attention), whatever implements it. Elementwise work (BN, PReLU, sigmoid,
softmax) is not counted, as is usual for a model's FLOPs.
"""

from __future__ import annotations

# IR-SE50: (in_channel, depth, units) per stage; every stage opens with stride 2
BLOCK_SPECS_50 = [(64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)]
# stage boundaries in the flat unit list: (unit_lo, unit_hi, input_hw, in_ch_first, out_ch)
STAGES_50 = [(0, 3, 112, 64, 64), (3, 7, 56, 64, 128),
             (7, 21, 28, 128, 256), (21, 24, 14, 256, 512)]
EMBED, FEAT_HW, HW = 512, 7, 49


def unit_configs():
    """Flat (in_channel, depth, stride) of IR-SE50's 24 bottleneck units."""
    units = []
    for in_ch, depth, num in BLOCK_SPECS_50:
        units.append((in_ch, depth, 2))
        units.extend((depth, depth, 1) for _ in range(num - 1))
    return units


def _unit_flops(h_in, cin, cout, stride):
    """MAC*2 for one IR-SE unit: conv1 3x3 s1 at input res + conv2 3x3
    stride + (projection shortcut if cin != cout)."""
    h_out = h_in // stride
    f = h_in * h_in * 9 * cin * cout * 2          # conv1
    f += h_out * h_out * 9 * cout * cout * 2      # conv2
    if cin != cout:
        f += h_out * h_out * cin * cout * 2       # 1x1 projection
    return f


def stage_flops(batch):
    """{stem, stage1..stage4, head: operations} of IR-SE50 at `batch`."""
    units = unit_configs()
    flops = {}
    for si, (lo, hi, hw, _, _) in enumerate(STAGES_50, start=1):
        total, h = 0, hw
        for (cin, cout, stride) in units[lo:hi]:
            total += _unit_flops(h, cin, cout, stride)
            h //= stride
        flops[f"stage{si}"] = total * batch
    flops["stem"] = 112 * 112 * 9 * 3 * 64 * 2 * batch
    flops["head"] = (512 * 7 * 7) * 512 * 2 * batch
    return flops


def encoder_flops(batch):
    return sum(stage_flops(batch).values())


def _conv3(cin, cout, hw=HW):
    return hw * 9 * cin * cout * 2


def recnet_flops(batch, c=EMBED, hw=HW):
    """RecNet's inference operations at `batch`: both cosine Grams, the
    conv chains (3x3 on the reflect-padded 7x7 map), Conv4Channel's six
    Linears on C rows, M_channel X and X M_space."""
    grams = 2 * hw * hw * c + 2 * c * c * hw
    space = (_conv3(c + hw, 256) + 2 * _conv3(256, 256) + _conv3(256, 128)
             + 2 * _conv3(128, 128) + _conv3(128, hw) + 2 * _conv3(hw, hw))
    channel = 2 * c * ((c + hw) * 32 + 32 * c + c * 32 + 32 * c + c * 32 + 32 * c)
    apply = 2 * c * c * hw + 2 * c * hw * hw
    merge = (_conv3(2 * c, c) + 2 * _conv3(c, c)) + (_conv3(3 * c, c) + 2 * _conv3(c, c))
    return batch * (grams + space + channel + apply + merge)


def embed_flops(batch):
    """One embed of `batch` faces: the encoder and RecNet."""
    return encoder_flops(batch) + recnet_flops(batch)


def train_step_flops(batch, num_classes=10575, c=EMBED):
    """One train step at `batch` pairs: the frozen encoder's forward on 2N
    faces, RecNet's forward and backward (twice the forward) on both
    branches, and the CosFace head's product (forward and backward) on
    both; no recomputation counted."""
    head = 2 * batch * c * num_classes
    return encoder_flops(2 * batch) + 3 * 2 * (recnet_flops(batch) + head)
