"""RecNet: spatial + channel feature rectification (FFR-Net head), NCHW.

Counterpart of ffrnet_tpu/models/recnet.py, inference and training. Module
names are the reference's state-dict keys (`Conv4Space`, `Conv4Channel`,
`ChannelFlipMerge`, `Conv4Merge`, `classifier`).

  1. self-similarity of the 7x7x512 map -> ss_space (N,49,49), ss_channel
  2. Conv4Space on cat(featmap, ss_space as a map) -> M_space (N,49,49)
  3. Conv4Channel on cat(flat, ss_channel) -> M_channel (N,512,512)
  4. feat_space = X M_space, feat_channel = M_channel X, X = (N,512,49)
  5. width flip of feat_channel, concat, ChannelFlipMerge
  6. Conv4Merge on cat(feat_space, feat_channel_m, featmap) -> feat_new
  7. 7x7 mean -> feat_new_v (N,512)
  8. with a label: the CosFace head's logits and cosines (`RecNetTrainOut`),
     over the head's class shard under a 'model' mesh axis (the feature
     enters through copy_to_group over `ops.nn.class_axis_group()`)

The BNs follow `module.training` (batch statistics and running-stat
updates in train mode, `layers.NormLayer`).

Config names, JAX -> port:

  ss_impl       'xla' -> 'plain'    normalize rows, then torch.bmm
                'pallas' -> 'kernel' the fused self-similarity wrapper; as
                                    in JAX it forces the materialized
                                    channel path
  c4c_impl      'factored' / 'materialized' (unchanged): the factored path
                never builds the (N, C, C) Gram (`_conv4channel_factored`)
  channel_impl  'xla' -> 'plain'    Conv4Channel as PyTorch ops, M_channel
                                    then M_channel X
                'pallas_fused' -> 'fused'  the fused channel-branch wrapper,
                                    which keeps M_channel on chip: factored
                                    path, eval mode and no label only (the
                                    train output holds M_channel)
  remat_channel in training, torch.utils.checkpoint around the channel
                branch (M_channel and its intermediates recomputed in the
                backward pass instead of stored)
  s, m          the CosFace head's scale and margin

The port's default is the fused configuration (c4c_impl='factored',
channel_impl='fused'). Whether a wrapper runs its CUDA kernel or its plain
twin is decided by the tensor's device inside the wrapper, never here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ffrnet_torch.models import layers as L
from ffrnet_torch.ops import nn as ops
from ffrnet_torch.ops.kernels.channel_branch import _collapse, channel_branch
from ffrnet_torch.ops.similarity import cosine_sim, self_similarity
from ffrnet_torch.parallel.collectives import copy_to_group


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
    remat_channel: bool = False   # checkpoint the channel branch in training

    def __post_init__(self):
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


class RecNetTrainOut(NamedTuple):
    """Training-mode outputs (ffrnet_tpu/models/recnet.py:74-85), NCHW where
    the JAX package's maps are NHWC."""
    feat_new_v: torch.Tensor    # (N, C) rectified embedding (not normalized)
    logits: torch.Tensor        # (N, classes) margin logits
    cosine: torch.Tensor        # (N, classes) raw cosines
    m_space: torch.Tensor       # (N, HW, HW)
    m_channel: torch.Tensor     # (N, C, C)
    feat_space: torch.Tensor    # (N, C, H, W) raw spatial-rectified map
    feat_channel: torch.Tensor  # (N, C, H, W) after ChannelFlipMerge


class CosFaceHead(nn.Module):
    """The AddMarginProduct weight (num_classes, C); `add_margin_logits`
    gives its logits. Under a 'model' mesh axis (training.trainer.
    bind_to_mesh) it holds one shard of the zero-padded class axis, rows
    [class_offset, class_offset + weight.shape[0])."""

    def __init__(self, num_classes: int, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_classes, channels))
        self.class_offset = 0


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

    def train(self, mode: bool = True) -> "RecNet":
        """Entering train mode drops the collapsed channel weights: they
        would be stale after an optimizer step."""
        if mode:
            self.channel_weights = None
        return super().train(mode)

    def forward(self, featmap, label=None):
        """featmap (N, C, H, W) -> (feat_new_v (N, C), feat_new (N, C, H, W));
        with a label (N,) -> RecNetTrainOut."""
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
        tree = self.c4c_params()
        if (factored and cfg.channel_impl == "fused" and label is None
                and not self.training):
            weights = self.channel_weights
            if weights is None:
                weights = _collapse(tree)
            m_channel, feat_channel = None, channel_branch(flat, weights)
        else:
            first = flat if factored else torch.cat([flat, ss_channel], dim=2)
            if cfg.remat_channel and self.training:
                m_channel, feat_channel = checkpoint(
                    _channel_attention, tree, first, flat, factored, use_reentrant=False)
            else:
                m_channel, feat_channel = _channel_attention(tree, first, flat, factored)

        # spatial rectification: feat_space[c, p] = sum_q X[c, q] M_space[q, p]
        feat_space = torch.bmm(flat, m_space).reshape(n, c, h, w)
        feat_channel = feat_channel.reshape(n, c, h, w)

        fc_cat = torch.cat([torch.flip(feat_channel, dims=[3]), feat_channel],
                           dim=1)  # width flip, then concat
        feat_channel_m = self.ChannelFlipMerge(fc_cat)
        merged = torch.cat([feat_space, feat_channel_m, featmap], dim=1)
        feat_new = self.Conv4Merge(merged)
        feat_new_v = feat_new.mean(dim=(2, 3))
        if label is None:
            return feat_new_v, feat_new
        # a class-sharded head sums its shards' gradients into the feature's
        # (the other losses' share stays as it is on every model rank)
        feat = copy_to_group(feat_new_v, ops.class_axis_group())
        logits, cosine = add_margin_logits(self.classifier.weight, feat, label, s=cfg.s,
                                           m=cfg.m, num_classes=cfg.num_classes,
                                           offset=self.classifier.class_offset)
        return RecNetTrainOut(feat_new_v, logits, cosine, m_space, m_channel,
                              feat_space, feat_channel_m)


def _pad_rows_masked(w, num_classes, offset=0):
    """(w with each padded row replaced by ones, valid-class mask or None);
    w's rows are the classes [offset, offset + w.shape[0]). Normalizing an
    all-zero padded row would put 0/0 into the backward pass, which a zero
    cotangent does not cancel; the constant row's cosines are masked, and
    torch.where gives the padded rows exactly zero gradient."""
    total = w.shape[0]
    if offset + total <= num_classes:
        return w, None
    valid = torch.arange(offset, offset + total, device=w.device) < num_classes
    return torch.where(valid[:, None], w, torch.ones((), dtype=w.dtype, device=w.device)), valid


def _mask_padded(logits, cosine, valid):
    """Padded classes: logits -1e5 (no softmax mass), cosines -2 (never the
    argmax)."""
    if valid is None:
        return logits, cosine
    return (torch.where(valid, logits, torch.full((), -1e5, dtype=logits.dtype,
                                                  device=logits.device)),
            torch.where(valid, cosine, torch.full((), -2.0, dtype=cosine.dtype,
                                                  device=cosine.device)))


def _one_hot(label, like, offset=0):
    """One-hot rows shaped and typed like `like`, whose columns are the
    classes [offset, offset + like.shape[1]); a label outside them gives a
    zero row. A scatter, since F.one_hot checks the labels' range on the
    host (a device sync)."""
    local = label.long() - offset
    own = (local >= 0) & (local < like.shape[1])
    idx = local.clamp(0, like.shape[1] - 1)[:, None]
    return torch.zeros_like(like).scatter_(1, idx, own[:, None].to(like.dtype))


def _cosines(w, feat):
    return ops.l2_normalize(feat, axis=1) @ ops.l2_normalize(w, axis=1).T


def add_margin_logits(w, feat, label, *, s: float, m: float, num_classes: int,
                      offset: int = 0):
    """CosFace / AddMarginProduct (ffrnet_tpu/models/recnet.py:148-185):
    w (classes, C), feat (N, C), label (N,) -> (logits, cosine), both
    (N, w.shape[0]). The margin is taken off the target class only and
    the logits are scaled by s. w may be the class shard [offset, offset +
    w.shape[0]) of a padded class axis; rows past `num_classes` are padding
    (`_pad_rows_masked`, `_mask_padded`)."""
    w, valid = _pad_rows_masked(w, num_classes, offset)
    cosine = _cosines(w, feat)
    one_hot = _one_hot(label, cosine, offset)
    logits = s * (cosine - m * one_hot)
    return _mask_padded(logits, cosine, valid)


def arc_margin_logits(w, feat, label, *, s: float = 30.0, m: float = 0.50,
                      easy_margin: bool = False, num_classes: int = 10575, offset: int = 0):
    """ArcFace / ArcMarginProduct (ffrnet_tpu/models/recnet.py:188-220), with
    the padded and sharded class contract of add_margin_logits."""
    w, valid = _pad_rows_masked(w, num_classes, offset)
    cosine = _cosines(w, feat)
    sine = torch.sqrt(torch.clamp(1.0 - cosine.square(), 0.0, 1.0))
    phi = cosine * math.cos(m) - sine * math.sin(m)
    if easy_margin:
        phi = torch.where(cosine > 0, phi, cosine)
    else:
        phi = torch.where(cosine > math.cos(math.pi - m), phi,
                          cosine - math.sin(math.pi - m) * m)
    one_hot = _one_hot(label, cosine, offset)
    logits = s * (one_hot * phi + (1.0 - one_hot) * cosine)
    return _mask_padded(logits, cosine, valid)


def _channel_attention(tree, first, flat, factored):
    """(M_channel (N, C, C), M_channel X (N, C, HW)) from the Conv4Channel
    tree; `first` is flat on the factored path, cat(flat, ss_channel) on
    the materialized one."""
    m_channel = (_conv4channel_factored(tree, first) if factored
                 else _conv4channel(tree, first))
    return m_channel, torch.bmm(m_channel, flat)


def _linear(p, x):
    return torch.nn.functional.linear(x, p["w"], p.get("b"))


def _conv4channel_factored(tree, flat, *, eps: float = 1e-12):
    """_conv4channel on cat(flat, ss_channel) without the (N, C, C) Gram
    (ffrnet_tpu/models/recnet.py:259-317): with lin0's weight split into the
    columns that meet flat (w1f) and those that meet the Gram (w1s),
    ss_channel w1s^T = ghat (ghat^T w1s^T), ghat the L2-normalized rows; and
    each (lin1, lin2), (lin3, lin4) pair, with no nonlinearity between them,
    collapses to one (32, 32) affine. The products the JAX package takes
    with preferred_element_type=float32 are taken in fp32 here and cast
    back at the same points."""
    f32 = torch.float32
    w1, b1 = tree["lin0"]["w"], tree["lin0"].get("b")
    q = flat.shape[2]
    w1f, w1s = w1[:, :q], w1[:, q:]
    ghat = ops.l2_normalize(flat, axis=2, eps=eps)
    h = flat.to(f32) @ w1f.to(f32).T                                # (N, C, 32)
    t = torch.matmul(w1s.to(f32), ghat.to(f32)).to(flat.dtype)      # (N, 32, HW)
    h = (h + ghat.to(f32) @ t.to(f32).transpose(1, 2)).to(flat.dtype)
    if b1 is not None:
        h = h + b1
    h = ops.prelu(h, tree["prelu0"]["slope"], axis=1)
    for i in (1, 2):
        pa, pb = tree[f"lin{2 * i - 1}"], tree[f"lin{2 * i}"]
        wc = (pb["w"].to(f32) @ pa["w"].to(f32)).to(h.dtype)
        ba, bc = pa.get("b"), pb.get("b")
        if ba is not None:
            bab = (pb["w"].to(f32) @ ba.to(f32)).to(h.dtype)
            bc = bab if bc is None else bab + bc
        h = F.linear(h, wc, bc)
        h = ops.prelu(h, tree[f"prelu{i}"]["slope"], axis=1)
    return torch.sigmoid(_linear(tree["lin5"], h))


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
    """An eval-mode RecNet on `device` (`.train()` for training), filled from `generator` (a CPU
    torch.Generator), or left for load_state_dict when None."""
    with torch.device("meta"):
        model = RecNet(cfg)
    model = model.to_empty(device="cpu")
    if generator is not None:
        init_recnet(model, generator)
    return model.to(device).eval()
