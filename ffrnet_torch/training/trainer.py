"""The single-card train step (ffrnet_tpu/training/trainer.py:36-214).

  * the frozen IR-SE50 encoder runs in eval mode under no_grad, one 2N pass
    for the clean and masked images (`encode_frozen`)
  * RecNet runs in train mode on the clean branch, then on the masked one:
    BN batch statistics, running stats moved in place clean first, then
    masked (the JAX package threads st1 -> st2)
  * the four-part objective (training/losses.py), its gradient, the
    elementwise clip at 1.0, the optimizer, MultiStepLR per iteration

Everything runs on the device of the state's RecNet; `create_train_state`
puts it on the card unless the caller asks for the CPU.

Mixed precision (compute_dtype='bf16') as in the JAX package: the forward
and backward run on a bf16 copy of the fp32 master parameters
(`torch.func.functional_call`), whose gradient reaches the masters through
the cast; the BN statistics, the running stats, the loss reductions and the
optimizer stay in fp32. The frozen features come in the compute type.

`remat` recomputes each RecNet branch in the backward pass
(torch.utils.checkpoint); the recompute leaves the BN running stats as the
first forward left them (`layers.running_stats_frozen`).

Feature dicts are NCHW: featmap_* (N, 512, 7, 7); the JAX package's are
NHWC. The class-axis padding and the mesh binding wait for the port's
parallelism.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ffrnet_torch.models import layers as L
from ffrnet_torch.models.recnet import RecNet, RecNetConfig, build_recnet
from ffrnet_torch.ops.nn import images_to_unit_range, tree_cast_floats
from ffrnet_torch.training import losses, optimizers, schedules


@dataclass(frozen=True)
class TrainerConfig:
    optimizer: str = "adam"
    lr: float = 1e-1
    beta1: float = 0.9
    beta2: float = 0.999
    momentum: float = 0.9
    nesterov: bool = False  # SGD only
    weight_decay: float = 0.0
    loss_weight: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    milestones: Tuple[int, ...] = (5000, 10000, 15000)
    lr_gamma: float = 0.5
    clip_value: float = 1.0
    faithful_ce_weight: bool = True
    ss_loss_impl: str = "factored"  # 'factored' | 'materialized'
    compute_dtype: str = "fp32"     # 'fp32' | 'bf16' (mixed precision)
    remat: bool = False             # recompute the RecNet branches in backward
    recnet: RecNetConfig = field(default_factory=RecNetConfig)

    def __post_init__(self):
        half_dtype(self.compute_dtype)
        if self.optimizer.lower() not in optimizers.OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.ss_loss_impl not in ("factored", "materialized"):
            raise ValueError(f"ss_loss_impl must be 'factored' or 'materialized', "
                             f"got {self.ss_loss_impl!r}")

    def lr_schedule(self):
        return schedules.multistep_lr(self.lr, self.milestones, self.lr_gamma)

    def make_optimizer(self, params) -> optimizers.ClippedOptimizer:
        return optimizers.make_optimizer(
            self.optimizer, params, self.lr_schedule(), b1=self.beta1, b2=self.beta2,
            momentum=self.momentum, weight_decay=self.weight_decay, nesterov=self.nesterov,
            clip_value=self.clip_value, base_lr=self.lr)


def half_dtype(compute_dtype: str):
    if compute_dtype not in ("fp32", "bf16"):
        raise ValueError(f"compute_dtype must be fp32|bf16, got {compute_dtype!r}")
    return torch.bfloat16 if compute_dtype == "bf16" else None


class TrainState:
    """RecNet in train mode (fp32 master parameters and BN running stats),
    its optimizer and the count of updates taken (ffrnet_tpu TrainState:
    params, model_state, opt_state, step). train_step* update it in place."""

    def __init__(self, model: RecNet, optimizer: optimizers.ClippedOptimizer, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step = step

    @property
    def device(self) -> torch.device:
        return self.model.classifier.weight.device


def create_train_state(cfg: TrainerConfig, *, seed: int = 1, device="cuda") -> TrainState:
    """A fresh state: RecNet from `seed` on `device`, in train mode. On the
    card in fp32, TF32 is switched off for cuDNN and cuBLAS (process-wide,
    as FFRNet.prepare does), so fp32 means fp32."""
    from ffrnet_torch.api import resolve_device

    dev = resolve_device(device)
    model = build_recnet(cfg.recnet, generator=torch.Generator().manual_seed(seed))
    model = model.to(dev).train()
    if dev.type == "cuda" and cfg.compute_dtype == "fp32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return TrainState(model, cfg.make_optimizer(model.parameters()))


def load_train_state(state: TrainState, recnet_sd, optimizer_state, step: int) -> TrainState:
    """Put a carried-over state into `state` (the trees of
    `checkpoint.convert.train_state_dicts`): RecNet's parameters and running
    stats, each parameter's optimizer state by key, and the update count."""
    state.model.load_state_dict(recnet_sd)
    params = dict(state.model.named_parameters())
    inner = state.optimizer.inner
    inner.state.clear()
    for key, st in optimizer_state.items():
        p = params[key]
        inner.state[p] = {k: v.to(p.device) if isinstance(v, torch.Tensor) and v.ndim else v
                          for k, v in st.items()}
    state.step = step
    return state


def _to(x, device):
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device, non_blocking=True)


def _unit(x, dtype):
    """NHWC images (uint8, or float in [-1, 1]) on the device -> NCHW in
    `dtype`; uint8 is normalized on the device."""
    return images_to_unit_range(x).to(dtype).permute(0, 3, 1, 2)


@torch.no_grad()
def encode_frozen(encoder, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The frozen encoder's features of one paired batch, in one 2N pass
    (eval mode: no batch statistics, so one pass equals two). batch:
    'img_non' and 'img_ocl' (N, 112, 112, 3) BGR, uint8 or [-1, 1], or
    packed 'imgs' (N, 2, 112, 112, 3); and 'label' (N,). Host arrays are
    moved to the encoder's device; images compute in its dtype (bf16 for
    mixed precision, as the JAX package casts the encoder's params).
    Returns FEATURE_KEYS, maps NCHW."""
    w = encoder.input_layer[0].weight
    dev, dt = w.device, w.dtype
    if "imgs" in batch:
        pairs = _to(batch["imgs"], dev)
        n = pairs.shape[0]
        both = torch.cat([pairs[:, 0], pairs[:, 1]], dim=0)
        x = _unit(both, dt)
    else:
        n = batch["img_non"].shape[0]
        x = torch.cat([_unit(_to(batch["img_non"], dev), dt),
                       _unit(_to(batch["img_ocl"], dev), dt)], dim=0)
    featmap, embed = encoder(x.contiguous())
    return {"featmap_non": featmap[:n], "featmap_ocl": featmap[n:],
            "embed_non": embed[:n], "embed_ocl": embed[n:],
            "label": _to(batch["label"], dev).long()}


def _unpack(feats):
    if "featmaps" in feats:  # packed (N, 2, ...) buffers
        return (feats["featmaps"][:, 0], feats["featmaps"][:, 1],
                feats["embeds"][:, 0], feats["embeds"][:, 1])
    return feats["featmap_non"], feats["featmap_ocl"], feats["embed_non"], feats["embed_ocl"]


def train_step_from_features(state: TrainState, feats, *, cfg: TrainerConfig):
    """One update of RecNet from frozen-encoder features (fresh from
    `encode_frozen`, or cached; host arrays are moved to the state's
    device). Returns (state, metrics), the metrics 0-d tensors on the
    device except LR (a float)."""
    model = state.model
    dev = state.device
    half = half_dtype(cfg.compute_dtype)
    dt = half or torch.float32
    featmap_non, featmap_ocl, embed_non, embed_ocl = (
        _to(t, dev).to(dt) for t in _unpack(feats))
    labels = _to(feats["label"], dev).long()

    params = tree_cast_floats(dict(model.named_parameters()), half)

    def branch(featmap):
        return functional_call(model, params, (featmap, labels))

    if cfg.remat:
        def run(featmap):
            return checkpoint(branch, featmap, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(),
                                                  L.running_stats_frozen(model)))
    else:
        run = branch

    out_non = run(featmap_non)
    out_ocl = run(featmap_ocl)
    lb = losses.ffrnet_objective(
        featmap_non=featmap_non, embed_non=embed_non, embed_ocl=embed_ocl,
        out_non=out_non, out_ocl=out_ocl, labels=labels, loss_weight=cfg.loss_weight,
        faithful_ce_weight=cfg.faithful_ce_weight, ss_impl=cfg.recnet.ss_impl,
        ss_loss_impl=cfg.ss_loss_impl)
    state.optimizer.zero_grad()
    lb.total.backward()
    lr = state.optimizer.step(state.step)
    state.step += 1
    metrics = {
        "SelfSimilarityLoss": lb.self_similarity.detach(),
        "TripletLoss": lb.triplet.detach(),
        "IdentityLoss": lb.identity.detach(),
        "ClassifierLoss": lb.classifier.detach(),
        "TotalLoss": lb.total.detach(),
        "TrainAcc": lb.accuracy,
        "PosDist": lb.pos_dist.detach(),
        "NegDist": lb.neg_dist.detach(),
        "LR": lr,
    }
    return state, metrics


def train_step(encoder, state: TrainState, batch, *, cfg: TrainerConfig):
    """One update from a paired image batch: encode_frozen, then
    train_step_from_features. The encoder is a Backbone on the state's
    device, in the compute type (`encoder.to(torch.bfloat16)` for bf16)."""
    want = half_dtype(cfg.compute_dtype) or torch.float32
    have = encoder.input_layer[0].weight.dtype
    if have != want:
        raise ValueError(f"train_step: the encoder is {have}, compute_dtype "
                         f"{cfg.compute_dtype!r} needs {want}")
    return train_step_from_features(state, encode_frozen(encoder, batch), cfg=cfg)


FEATURE_KEYS = ("featmap_non", "featmap_ocl", "embed_non", "embed_ocl", "label")
#: packed layout: featmaps/embeds carry both streams on axis 1
PACKED_FEATURE_KEYS = ("featmaps", "embeds", "label")
#: the pack= spec that gives the packed layout from FEATURE_KEYS
FEATURE_PACK = {"featmaps": ("featmap_non", "featmap_ocl"),
                "embeds": ("embed_non", "embed_ocl")}
