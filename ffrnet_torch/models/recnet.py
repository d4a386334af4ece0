"""RecNet inference: spatial + channel feature rectification (FFR-Net head), NCHW.

Counterpart of ffrnet_tpu/models/recnet.py (inference only; the margin heads'
logits and RecNetTrainOut wait for the training port). Module names are the
reference's state-dict keys (`Conv4Space`, `Conv4Channel`,
`ChannelFlipMerge`, `Conv4Merge`, `classifier`).

  1. self-similarity of the 7x7x512 map -> ss_space (N,49,49), ss_channel
  2. Conv4Space on cat(featmap, ss_space as a map) -> M_space (N,49,49)
  3. Conv4Channel on cat(flat, ss_channel) -> M_channel (N,512,512)
  4. feat_space = X M_space, feat_channel = M_channel X, X = (N,512,49)
  5. width flip of feat_channel, concat, ChannelFlipMerge
  6. Conv4Merge on cat(feat_space, feat_channel_m, featmap) -> feat_new
  7. 7x7 mean -> feat_new_v (N,512)

Config names, JAX -> port:

  ss_impl       'xla' -> 'plain'    normalize rows, then torch.bmm
                'pallas' -> 'kernel' the fused self-similarity wrapper; as
                                    in JAX it forces the materialized
                                    channel path
  c4c_impl      'factored' / 'materialized' (unchanged)
  channel_impl  'xla' -> 'plain'    factored: the channel branch's plain
                                    PyTorch version (channel_branch_plain);
                                    materialized: Conv4Channel's linears
                'pallas_fused' -> 'fused'  the fused channel-branch wrapper
                                    (factored path only)
  remat_channel training only; the port has no training yet, so only
                False is taken
  s, m          the CosFace head's scale and margin, read by training only

The port's default is the fused configuration (c4c_impl='factored',
channel_impl='fused'). Whether a wrapper runs its CUDA kernel or its plain
twin is decided by the tensor's device inside the wrapper, never here.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ffrnet_torch.models import layers as L
from ffrnet_torch.ops import nn as ops
from ffrnet_torch.ops.kernels.channel_branch import (_collapse, channel_branch,
                                                     channel_branch_plain)
from ffrnet_torch.ops.similarity import cosine_sim, self_similarity


@dataclass(frozen=True)
class RecNetConfig:
    channel: int = 512
    shape: int = 7  # spatial side of the feature map
    norm_type: str = "bn"
    relu_type: str = "prelu"
    num_classes: int = 10575
    s: float = 30.0   # CosFace scale (training)
    m: float = 0.40   # CosFace margin (training)
    ss_impl: str = "plain"        # 'plain' | 'kernel'
    c4c_impl: str = "factored"    # 'factored' | 'materialized'
    channel_impl: str = "fused"   # 'plain' | 'fused'
    remat_channel: bool = False   # training only

    def __post_init__(self):
        if self.remat_channel:
            raise ValueError("remat_channel applies to training, which the port "
                             "does not run yet")
        if self.ss_impl not in ("plain", "kernel"):
            raise ValueError(f"ss_impl must be 'plain' or 'kernel', got {self.ss_impl!r}")
        if self.c4c_impl not in ("factored", "materialized"):
            raise ValueError(f"c4c_impl must be 'factored' or 'materialized', "
                             f"got {self.c4c_impl!r}")
        if self.channel_impl not in ("plain", "fused"):
            raise ValueError(f"channel_impl must be 'plain' or 'fused', "
                             f"got {self.channel_impl!r}")

    @property
    def hw(self) -> int:
        return self.shape * self.shape


# the ss-kernel configuration of the slice: self-similarity kernel,
# materialized channel path
SS_KERNEL_CONFIG = RecNetConfig(ss_impl="kernel", c4c_impl="materialized",
                                channel_impl="plain")


class CosFaceHead(nn.Module):
    """Holds the AddMarginProduct weight (num_classes, C) so that released
    checkpoints load; its logits belong to the training port."""

    def __init__(self, num_classes: int, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_classes, channels))


_LIN_IDX = (0, 2, 3, 5, 6, 8)
_PRELU_IDX = (1, 4, 7)


class RecNet(nn.Module):
    def __init__(self, cfg: RecNetConfig = RecNetConfig()):
        super().__init__()
        self.cfg = cfg
        c, hw = cfg.channel, cfg.hw
        kw = {"norm_type": cfg.norm_type, "relu_type": cfg.relu_type}
        self.Conv4Space = nn.Sequential(
            L.ConvLayer(c + hw, 256, 3, **kw), L.ResidualBlock(256, 3, **kw),
            L.ConvLayer(256, 128, 3, **kw), L.ResidualBlock(128, 3, **kw),
            L.ConvLayer(128, hw, 3, **kw), L.ResidualBlock(hw, 3, **kw),
            nn.Sigmoid())
        self.Conv4Channel = nn.Sequential(
            nn.Linear(c + hw, 32), L.ReluLayer(c, "prelu"), nn.Linear(32, c),
            nn.Linear(c, 32), L.ReluLayer(c, "prelu"), nn.Linear(32, c),
            nn.Linear(c, 32), L.ReluLayer(c, "prelu"), nn.Linear(32, c),
            nn.Sigmoid())
        self.ChannelFlipMerge = nn.Sequential(
            L.ConvLayer(2 * c, c, 3, **kw), L.ResidualBlock(c, 3, **kw))
        self.Conv4Merge = nn.Sequential(
            L.ConvLayer(3 * c, c, 3, **kw), L.ResidualBlock(c, 3, **kw))
        self.classifier = CosFaceHead(cfg.num_classes, c)
        self.channel_weights = None

    @torch.no_grad()
    def collapse_channel_weights(self) -> "RecNet":
        """Collapse Conv4Channel into the factored channel branch's operands
        (`_collapse`) once, after the last change to the weights, device or
        dtype; FFRNet.prepare calls it. Until then each forward collapses."""
        self.channel_weights = _collapse(self.c4c_params())
        return self

    def c4c_params(self) -> dict:
        """Conv4Channel as the JAX package's tree: lin0..lin5 {w, b} and
        prelu0..prelu2 {slope}."""
        tree = {}
        for i, idx in enumerate(_LIN_IDX):
            lin = self.Conv4Channel[idx]
            tree[f"lin{i}"] = {"w": lin.weight, "b": lin.bias}
        for i, idx in enumerate(_PRELU_IDX):
            tree[f"prelu{i}"] = {"slope": self.Conv4Channel[idx].func.weight}
        return tree

    def forward(self, featmap):
        """featmap (N, C, H, W) -> (feat_new_v (N, C), feat_new (N, C, H, W))."""
        cfg = self.cfg
        n, c, h, w = featmap.shape
        hw = h * w
        flat = featmap.reshape(n, c, hw)  # rows = channels
        factored = cfg.c4c_impl == "factored" and cfg.ss_impl != "kernel"

        if factored:  # the factored channel path never needs ss_channel
            pos = flat.transpose(1, 2)
            ss_space = cosine_sim(pos, pos)
        else:
            ss_space, ss_channel = self_similarity(featmap, impl=cfg.ss_impl)

        # spatial attention: ss_space (N, p, q) is a map with channels p and
        # spatial position q; the map's output (N, p, qh, qw) reshapes to
        # M_space (N, p, q) with no transpose in NCHW
        space_cat = torch.cat([featmap, ss_space.reshape(n, hw, h, w)], dim=1)
        m_space = self.Conv4Space(space_cat).reshape(n, hw, hw)

        # channel attention -> feat_channel (N, C, HW) = M_channel X
        if factored:
            weights = self.channel_weights
            if weights is None:
                weights = _collapse(self.c4c_params())
            branch = channel_branch if cfg.channel_impl == "fused" else channel_branch_plain
            feat_channel = branch(flat, weights)
        else:
            m_channel = _conv4channel(self.c4c_params(),
                                      torch.cat([flat, ss_channel], dim=2))
            feat_channel = torch.bmm(m_channel, flat)

        # spatial rectification: feat_space[c, p] = sum_q X[c, q] M_space[q, p]
        feat_space = torch.bmm(flat, m_space).reshape(n, c, h, w)
        feat_channel = feat_channel.reshape(n, c, h, w)

        fc_cat = torch.cat([torch.flip(feat_channel, dims=[3]), feat_channel],
                           dim=1)  # width flip, then concat
        feat_channel_m = self.ChannelFlipMerge(fc_cat)
        merged = torch.cat([feat_space, feat_channel_m, featmap], dim=1)
        feat_new = self.Conv4Merge(merged)
        return feat_new.mean(dim=(2, 3)), feat_new


def _linear(p, x):
    return torch.nn.functional.linear(x, p["w"], p.get("b"))


def _conv4channel(tree, x):
    """Three Linear(->32) -> PReLU(512 rows) -> Linear(->512) blocks and a
    sigmoid, on x (N, 512, 561). The PReLU slopes broadcast over dim 1."""
    for i in range(3):
        x = _linear(tree[f"lin{2 * i}"], x)
        x = ops.prelu(x, tree[f"prelu{i}"]["slope"], axis=1)
        x = _linear(tree[f"lin{2 * i + 1}"], x)
    return torch.sigmoid(x)


@torch.no_grad()
def init_recnet(model: RecNet, generator: torch.Generator) -> None:
    """Random init as ffrnet_tpu.models.recnet.init: kaiming-normal convs
    and linears, zero biases, BN weight ~ N(1, 0.02), PReLU 0.25, and a
    xavier-uniform classifier."""
    for m in model.modules():
        if isinstance(m, L.ConvLayer):
            L.init_conv_layer(m, generator)
        elif isinstance(m, nn.Linear):
            L.init_linear(m, generator)
        elif isinstance(m, L.ReluLayer) and m.relu_type == "prelu":
            m.func.weight.fill_(0.25)
    c = model.cfg.channel
    w = model.classifier.weight
    w.copy_(ops.xavier_uniform(w.shape, c, model.cfg.num_classes,
                               generator=generator))


def build_recnet(cfg: RecNetConfig = RecNetConfig(), *, generator=None,
                 device="cpu") -> RecNet:
    """An eval-mode RecNet on `device`, filled from `generator` (a CPU
    torch.Generator), or left for load_state_dict when None."""
    with torch.device("meta"):
        model = RecNet(cfg)
    model = model.to_empty(device="cpu")
    if generator is not None:
        init_recnet(model, generator)
    return model.to(device).eval()
