"""Sharded checkpoints of the train state (ffrnet_tpu/checkpoint/orbax_io.py),
on torch.distributed.checkpoint (DCP). The format is DCP's, not Orbax's:
the directory names are the JAX package's, `orbax_{step:09d}`, so that the
driver's cadence and retention are the same, but neither package reads the
other's sharded checkpoints. The pth store (checkpoint/store.py) stays the
interchange format.

Every rank of the mesh takes part in a save and writes only its own part
(`__<rank>_0.distcp`); nothing is gathered. The classifier and its
optimizer moments are DTensors over the ('data', 'model') mesh with
placements (Replicate(), Shard(0)) and the unpadded logical shape
(num_classes, C): each model rank holds its class rows, the last shard
short, and DCP writes each shard once. Everything else is replicated and
written once. A load reads whole tensors, so a checkpoint written under one
mesh resumes under any other (or in one process), as the JAX package's
restore-then-place does: the trainer pads and shards after the load.

A save is written under `orbax_{step:09d}.tmp` and renamed after DCP has
written its `.metadata`; `latest_orbax_step` and `load_orbax(step=None)`
take only the exact names that hold a `.metadata`, so a crashed save never
becomes the latest (ffrnet_tpu/checkpoint/orbax_io.py:68-71).

The tree is flat: 'params/<key>' and 'model_state/<key>' (RecNet's
parameters and buffers under its state-dict keys), 'opt/<key>/<entry>'
(torch.optim state), 'epoch', 'iter' and 'step'.
"""

from __future__ import annotations

import contextlib
import os
import re
import shutil
import warnings
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

_NAME = re.compile(r"orbax_\d{9}")


def _complete(ckpt_dir: str):
    """The finished step directories, oldest first."""
    return sorted(d for d in os.listdir(ckpt_dir)
                  if _NAME.fullmatch(d) and os.path.isfile(os.path.join(ckpt_dir, d, ".metadata")))


@contextlib.contextmanager
def _quiet():
    """DCP warns at every call outside a process group that it assumes one
    process; that is the intent here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*assuming the intent is to")
        yield


def _barrier(process_group) -> None:
    if dist.is_initialized():
        dist.barrier(group=process_group)


def _is_writer(process_group) -> bool:
    return not dist.is_initialized() or dist.get_rank(process_group) == 0


def save_orbax(ckpt_dir: str, step: int, tree: Dict[str, Any], *, process_group=None) -> str:
    """Write `tree` (`train_state_tree`) at `step`: every rank of
    `process_group` (default: the default group) calls it. An existing
    directory of that step is replaced. Returns the path."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(os.path.join(ckpt_dir, f"orbax_{step:09d}"))
    tmp = path + ".tmp"
    if _is_writer(process_group):
        shutil.rmtree(tmp, ignore_errors=True)
    _barrier(process_group)
    with _quiet():
        dcp.save(tree, storage_writer=dcp.FileSystemWriter(tmp), process_group=process_group)
    if _is_writer(process_group):  # DCP has written .metadata: publish the step
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
    _barrier(process_group)
    return path


def latest_orbax_step(ckpt_dir: str) -> Optional[int]:
    """Newest completed step in ckpt_dir, or None."""
    cands = _complete(ckpt_dir)
    return int(cands[-1].split("_")[1]) if cands else None


def prune_orbax(ckpt_dir: str, *, keep_every: int, keep_last: int = 2) -> int:
    """Remove the completed step directories that are neither multiples of
    `keep_every` (the reference's numbered cadence) nor among the newest
    `keep_last` (the 'latest' role). Returns the number removed. One rank
    calls it, after the save's barrier."""
    cands = _complete(ckpt_dir)
    removed = 0
    for d in cands[:-keep_last] if keep_last else cands:
        if keep_every and int(d.split("_")[1]) % keep_every == 0:
            continue
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
        removed += 1
    return removed


def load_orbax(ckpt_dir: str, step: Optional[int] = None, *, process_group=None) -> Dict[str, Any]:
    """The tree saved at `step` (None: the latest completed one), every
    tensor whole and on the CPU. Under a process group every rank of
    `process_group` calls it."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    if step is None:
        step = latest_orbax_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no orbax checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"orbax_{step:09d}")
    reader = dcp.FileSystemReader(path)
    tree: Dict[str, Any] = {}
    for key, md in reader.read_metadata().state_dict_metadata.items():
        tree[key] = (torch.empty(md.size, dtype=md.properties.dtype)
                     if isinstance(md, TensorStorageMetadata) else None)
    with _quiet():
        dcp.load(tree, storage_reader=reader, process_group=process_group)
    return tree


def class_rows_dtensor(x, mesh, num_classes: int, offset: int):
    """The unpadded rows of `x`, the class shard [offset, offset +
    x.shape[0]) of a padded class axis, as a DTensor of logical shape
    (num_classes, ...) over the ('data', 'model') `mesh`, placed
    (Replicate(), Shard(0)). Raises where DTensor's Shard(0) layout (that of
    torch.chunk) would put other rows on this rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    lo, hi = min(offset, num_classes), min(offset + x.shape[0], num_classes)
    shape = (num_classes,) + tuple(x.shape[1:])
    placements = [Replicate(), Shard(0)]
    local_shape, start = compute_local_shape_and_global_offset(shape, mesh, placements)
    if tuple(local_shape) != (hi - lo,) + shape[1:] or (hi > lo and start[0] != lo):
        raise ValueError(f"class shard rows [{lo}, {hi}) of {num_classes} are not DTensor's "
                         f"Shard(0) shard {tuple(start)} + {tuple(local_shape)} on {mesh}")
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(x[lo - offset:hi - offset].contiguous(), mesh, placements,
                              shape=shape, stride=stride, run_check=False)


@torch.no_grad()
def train_state_tree(state, mesh, *, epoch: int, iteration: int) -> Dict[str, Any]:
    """The flat tree of a TrainState for save_orbax. Under a 'model' axis
    of more than one rank (`state` bound by trainer.bind_to_mesh to `mesh`)
    the classifier and its trainer.classifier_moments are DTensors of this
    rank's unpadded rows; every other tensor is this rank's own
    (replicated) copy."""
    from ffrnet_torch.parallel import mesh_axes
    from ffrnet_torch.training.trainer import classifier_moments

    cls = state.model.classifier.weight
    rows = {id(cls): cls, **{id(v): v for v in classifier_moments(state).values()}}
    if mesh_axes(mesh)["model"] == 1:
        rows = {}
    names = {id(p): k for k, p in state.model.named_parameters()}

    def leaf(x):
        if id(x) in rows:
            return class_rows_dtensor(x.detach(), mesh, state.model.cfg.num_classes,
                                      state.model.classifier.class_offset)
        return x.detach() if isinstance(x, torch.Tensor) else x

    tree: Dict[str, Any] = {}
    for k, v in state.model.named_parameters():
        tree[f"params/{k}"] = leaf(v)
    for k, v in state.model.named_buffers():
        tree[f"model_state/{k}"] = v.detach()
    for p, st in state.optimizer.inner.state.items():
        for entry, v in st.items():
            if v is not None:
                tree[f"opt/{names[id(p)]}/{entry}"] = leaf(v)
    tree.update(epoch=int(epoch), iter=int(iteration), step=int(state.step))
    return tree


def state_dicts_from_tree(tree: Dict[str, Any]):
    """-> (RecNet state dict, {parameter key: optimizer state}, {'epoch',
    'iter', 'step'}) of a loaded tree, as trainer.load_train_state and the
    pth store take them."""
    sd, opt = {}, {}
    for key, v in tree.items():
        kind, _, rest = key.partition("/")
        if kind in ("params", "model_state"):
            sd[rest] = v
        elif kind == "opt":
            name, _, entry = rest.rpartition("/")
            opt.setdefault(name, {})[entry] = v
    return sd, opt, {k: int(tree[k]) for k in ("epoch", "iter", "step")}
