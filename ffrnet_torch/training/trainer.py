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
NHWC.

Data parallelism (`make_distributed_step`, `make_distributed_feature_step`,
or `group=` of the steps): each rank runs the step on its shard of the
global batch; RecNet's train-mode BNs take the global batch's statistics
(ops.nn.batch_stats_group), and the gradients are averaged over the data
group between the backward pass and the clip, as the JAX package clips
the global gradient. The returned metrics are the rank's own (means over
its shard); `parallel.collectives.average_tensor` gives the global ones.

The class axis (a 'model' mesh axis of M > 1; `model_group=` of the
steps): `bind_to_mesh` zero-pads the CosFace classifier and its optimizer
moments to padded_num_classes(num_classes, M) rows and keeps this rank's
shard (ffrnet_tpu/training/trainer.py:217-298). The head's input goes
through copy_to_group (models/recnet.py), so only the head's share of the
feature's gradient is summed over the model group; the softmax
cross-entropy and the accuracy's argmax run over every shard
(training/losses.py). The ranks of a model group hold the same batch
shard. The classifier shard's gradient is averaged over the data group
(the ranks that hold the same rows), the replicated parameters' over every
rank of the mesh: they are equal across the model axis to rounding, and
the mean keeps them bit-identical where the card's backward is not
deterministic. `gather_train_state` gathers and unpads the state for the
pth store.
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
from ffrnet_torch.ops.nn import (batch_stats_group, class_axis, images_to_unit_range,
                                 tree_cast_floats)
from ffrnet_torch.parallel import (class_shard, collectives, data_group, group_size, mesh_axes,
                                   mesh_coordinate, model_group, padded_num_classes)
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
    stats, a copy of each parameter's optimizer state by key, and the
    update count."""
    state.model.load_state_dict(recnet_sd)
    params = dict(state.model.named_parameters())
    inner = state.optimizer.inner
    inner.state.clear()
    for key, st in optimizer_state.items():
        p = params[key]
        # copies: the optimizer updates its state in place, and the caller's
        # trees must not move with it
        inner.state[p] = {k: v.to(p.device, copy=True) if isinstance(v, torch.Tensor) and v.ndim
                          else v for k, v in st.items()}
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


def train_step_from_features(state: TrainState, feats, *, cfg: TrainerConfig, group=None,
                             model_group=None):
    """One update of RecNet from frozen-encoder features (fresh from
    `encode_frozen`, or cached; host arrays are moved to the state's
    device). Returns (state, metrics), the metrics 0-d tensors on the
    device except LR (a float). group: the data group when `feats` is
    this rank's shard of a global batch. model_group: the model group over
    which the state's classifier is sharded (`bind_to_mesh`); its ranks
    take the same `feats`, and the mesh spans the default group."""
    if group_size(group) == 1:
        group = None
    if group_size(model_group) == 1:
        model_group = None
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

    # the recompute of --remat runs inside both, too
    with batch_stats_group(group), class_axis(model_group):
        out_non = run(featmap_non)
        out_ocl = run(featmap_ocl)
        lb = losses.ffrnet_objective(
            featmap_non=featmap_non, embed_non=embed_non, embed_ocl=embed_ocl,
            out_non=out_non, out_ocl=out_ocl, labels=labels, loss_weight=cfg.loss_weight,
            faithful_ce_weight=cfg.faithful_ce_weight, ss_impl=cfg.recnet.ss_impl,
            ss_loss_impl=cfg.ss_loss_impl, class_offset=model.classifier.class_offset,
            class_group=model_group)
        state.optimizer.zero_grad()
        lb.total.backward()
    # the global gradient, then the clip
    if model_group is not None:
        cls = model.classifier.weight
        collectives.average_gradients([p for p in state.optimizer.params if p is not cls],
                                      torch.distributed.group.WORLD)
        if group is not None:
            collectives.average_gradients([cls], group)
    elif group is not None:
        collectives.average_gradients(state.optimizer.params, group)
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


def train_step(encoder, state: TrainState, batch, *, cfg: TrainerConfig, group=None,
               model_group=None):
    """One update from a paired image batch: encode_frozen, then
    train_step_from_features. The encoder is a Backbone on the state's
    device, in the compute type (`encoder.to(torch.bfloat16)` for bf16).
    group: the data group when `batch` is this rank's shard; model_group:
    as in train_step_from_features."""
    want = half_dtype(cfg.compute_dtype) or torch.float32
    have = encoder.input_layer[0].weight.dtype
    if have != want:
        raise ValueError(f"train_step: the encoder is {have}, compute_dtype "
                         f"{cfg.compute_dtype!r} needs {want}")
    return train_step_from_features(state, encode_frozen(encoder, batch), cfg=cfg, group=group,
                                    model_group=model_group)


def classifier_moments(state: TrainState) -> Dict[str, torch.Tensor]:
    """The classifier's optimizer entries that mirror its rows (momentum,
    moments; not Adam's 0-d step). The torch optimizer keys its state by
    parameter, so no other parameter's entries can match (the JAX package
    matches by tree path and shape, ffrnet_tpu/training/trainer.py:227-235)."""
    p = state.model.classifier.weight
    return {k: v for k, v in state.optimizer.inner.state.get(p, {}).items()
            if isinstance(v, torch.Tensor) and v.shape == p.shape}


def _map_classifier_rows(state: TrainState, fn) -> None:
    """Replace the classifier weight by fn(weight), and each of its
    classifier_moments by fn(entry)."""
    p = state.model.classifier.weight
    with torch.no_grad():
        for k, v in classifier_moments(state).items():
            state.optimizer.inner.state[p][k] = fn(v)
        p.data = fn(p.data)


def pad_train_state_classes(state: TrainState, rows: int) -> TrainState:
    """Zero-pad the classifier's class axis, and the optimizer state that
    mirrors it, to `rows` (in place; ffrnet_tpu/training/trainer.py:244-262).
    The padded rows are inert: add_margin_logits masks them out of the
    softmax, so their gradient is exactly zero and they stay zero. No-op
    when the classifier already has `rows` rows."""
    have = state.model.classifier.weight.shape[0]
    if have > rows:
        raise ValueError(f"classifier has {have} rows > target {rows}")
    if have < rows:
        _map_classifier_rows(
            state, lambda x: torch.cat([x, x.new_zeros((rows - have,) + x.shape[1:])]))
    return state


def unpad_train_state_classes(state: TrainState, num_classes: int) -> TrainState:
    """Inverse of pad_train_state_classes: the classifier and its optimizer
    state sliced back to `num_classes` rows (in place)."""
    if state.model.classifier.weight.shape[0] != num_classes:
        _map_classifier_rows(state, lambda x: x[:num_classes].clone())
    return state


def bind_to_mesh(mesh, state: TrainState):
    """-> (data group, model group) of `mesh` for `state`'s steps (None for
    an axis of one rank). Rank 0's RecNet parameters and buffers are
    broadcast to every rank of the mesh. Under a 'model' axis of M > 1 the
    classifier and its optimizer state are then padded to
    padded_num_classes(num_classes, M) rows and cut to this rank's shard
    `class_shard(num_classes, M, j)` (the counterpart of the JAX package's
    placement with P("model", None)); the mesh must span the default group."""
    n_model = mesh_axes(mesh)["model"]
    group, mgroup = data_group(mesh), model_group(mesh)
    if mgroup is not None:
        n_mesh, num = mesh_axes(mesh)["data"] * n_model, state.model.cfg.num_classes
        if n_mesh != torch.distributed.get_world_size():
            raise ValueError(f"a 'model' axis needs a mesh over every rank: {n_mesh} of "
                             f"{torch.distributed.get_world_size()}")
        if state.model.classifier.weight.shape[0] != num:
            raise ValueError(f"bind_to_mesh: the classifier has "
                             f"{state.model.classifier.weight.shape[0]} rows, not the "
                             f"{num} classes (bound already?)")
        collectives.broadcast_tensors(state.model.state_dict().values(),
                                      torch.distributed.group.WORLD)
        pad_train_state_classes(state, padded_num_classes(num, n_model))
        off, rows = class_shard(num, n_model, mesh_coordinate(mesh)[1])
        _map_classifier_rows(state, lambda x: x[off:off + rows].clone())
        state.model.classifier.class_offset = off
    elif group is not None:
        collectives.broadcast_tensors(state.model.state_dict().values(), group)
    return group, mgroup


@torch.no_grad()
def gather_train_state(state: TrainState, model_group=None):
    """-> (RecNet state dict, {parameter key: optimizer state}) on the CPU
    with the whole classifier: gathered over `model_group` (every rank of it
    takes part) and unpadded to num_classes, as the pth store keeps it
    (ffrnet_tpu/train.py:580-582)."""
    from ffrnet_torch.checkpoint.store import optimizer_state_by_key

    num = state.model.cfg.num_classes
    p = state.model.classifier.weight

    def whole(x):
        if model_group is not None:
            x = collectives.all_gather_rows(x, model_group)
        return x[:num].cpu().clone()

    sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    sd["classifier.weight"] = whole(p)
    opt = optimizer_state_by_key(state.model, state.optimizer.inner)
    for k, v in classifier_moments(state).items():
        opt["classifier.weight"][k] = whole(v)
    return sd, opt


def _check_layout(batch, keys, packed):
    if (keys[0] in batch) != packed:
        raise ValueError(f"the step was bound with packed={packed}; the batch has keys "
                         f"{sorted(batch)}")


def make_distributed_step(mesh, cfg: TrainerConfig, encoder, state: TrainState,
                          packed: bool = False):
    """Bind train_step to a mesh (ffrnet_tpu/training/trainer.py:301-343).

    Returns (step, (encoder, state)); call step(encoder, state, batch) on
    every rank with its data coordinate's shard of the global batch ('imgs'
    and 'label' if packed, else 'img_non', 'img_ocl', 'label'; the ranks of
    a model group take the same shard). Under a 'model' axis the state's
    classifier is padded and sharded (bind_to_mesh); slice checkpoints back
    with gather_train_state. The metrics are the rank's own."""
    group, mgroup = bind_to_mesh(mesh, state)

    def step(encoder, state, batch):
        _check_layout(batch, ("imgs",), packed)
        return train_step(encoder, state, batch, cfg=cfg, group=group, model_group=mgroup)

    return step, (encoder, state)


FEATURE_KEYS = ("featmap_non", "featmap_ocl", "embed_non", "embed_ocl", "label")
#: packed layout: featmaps/embeds carry both streams on axis 1
PACKED_FEATURE_KEYS = ("featmaps", "embeds", "label")
#: the pack= spec that gives the packed layout from FEATURE_KEYS
FEATURE_PACK = {"featmaps": ("featmap_non", "featmap_ocl"),
                "embeds": ("embed_non", "embed_ocl")}


def make_distributed_feature_step(mesh, cfg: TrainerConfig, state: TrainState,
                                  packed: bool = False):
    """Bind train_step_from_features to a mesh (feature-cached training;
    ffrnet_tpu/training/trainer.py:360-392). Returns (step, state); call
    step(state, feats) on every rank with its data coordinate's shard
    (PACKED_FEATURE_KEYS if packed, else FEATURE_KEYS). The class axis as
    in make_distributed_step."""
    group, mgroup = bind_to_mesh(mesh, state)

    def step(state, feats):
        _check_layout(feats, PACKED_FEATURE_KEYS, packed)
        return train_step_from_features(state, feats, cfg=cfg, group=group, model_group=mgroup)

    return step, state
