"""Checkpoint store with the reference's cadence and format
(ffrnet_tpu/checkpoint/store.py).

A checkpoint is a `.pth.gzip` file holding
  {'RecNet': <state dict under the reference's keys>, 'epoch': int,
   'iter': int, 'optimizer_torch': {parameter key: torch.optim state}}
The 'RecNet' entry loads into the PyTorch reference and into the JAX
package (`ffrnet_tpu.checkpoint.store.load_checkpoint`), which ignores the
port's optimizer entry. The port resumes from its own checkpoints and from
the JAX package's, whose optimizer state is the flat optax leaf list
'optimizer_tpu' (mapped by `convert.optimizer_state_from_leaves`).

Cadence (the driver, train.py): 'latest' every save_freq//10 iterations, a
numbered '{iter:07d}' file every save_freq; 'latest' resolves to the
lexicographically largest *.pth.gzip name.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch

from ffrnet_torch.checkpoint.convert import STATE_NAMES, optimizer_state_from_leaves
from ffrnet_torch.checkpoint.pth_io import load_pth, save_pth

OPTIMIZER_KEY = "optimizer_torch"
JAX_OPTIMIZER_KEY = "optimizer_tpu"


def _cpu(v):
    return v.detach().cpu() if isinstance(v, torch.Tensor) else v


def optimizer_state_by_key(model: torch.nn.Module, optimizer: torch.optim.Optimizer):
    """{RecNet parameter key: that parameter's torch.optim state}, on the CPU."""
    names = {id(p): k for k, p in model.named_parameters()}
    return {names[id(p)]: {k: _cpu(v) for k, v in st.items()}
            for p, st in optimizer.state.items()}


def save_checkpoint(ckpt_dir: str, file_name: str, *, model, optimizer=None, epoch: int = 0,
                    iteration: int = 0, extra: Optional[Dict[str, Any]] = None) -> str:
    """Write `{file_name}.pth.gzip` atomically: a pid-tagged dot-file, then
    os.replace, so a crash never leaves a truncated checkpoint under a name
    that `resolve_latest` would pick. Returns the path.

    model: a RecNet, or its state dict; optimizer: its torch optimizer, or
    the {parameter key: state} dict (both dicts as
    `training.trainer.gather_train_state` gives them for a class-sharded
    state)."""
    sd = model if isinstance(model, Mapping) else model.state_dict()
    payload: Dict[str, Any] = {
        "RecNet": {k: _cpu(v) for k, v in sd.items()},
        "epoch": int(epoch),
        "iter": int(iteration),
    }
    if optimizer is not None:
        payload[OPTIMIZER_KEY] = (dict(optimizer) if isinstance(optimizer, Mapping)
                                  else optimizer_state_by_key(model, optimizer))
    if extra:
        payload.update(extra)
    path = os.path.join(ckpt_dir, file_name + ".pth.gzip")
    tmp = os.path.join(ckpt_dir, f".{file_name}.tmp.{os.getpid()}.pth.gzip")
    save_pth(payload, tmp)
    os.replace(tmp, path)
    return path


def resolve_latest(ckpt_dir: str, file_name: str = "latest") -> str:
    """'latest' -> the lexicographic maximum of the *.pth.gzip names, dot-files
    (unfinished writes) skipped; a plain name gets '.pth.gzip' appended; an
    on-disk name or a path with '/' is taken as given."""
    if file_name == "latest":
        cands = sorted(x for x in os.listdir(ckpt_dir)
                       if x.endswith("pth.gzip") and not x.startswith("."))
        if not cands:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
        return os.path.join(ckpt_dir, cands[-1])
    if "/" in file_name:
        return file_name
    if file_name.endswith(".pth.gzip"):
        return os.path.join(ckpt_dir, file_name)
    return os.path.join(ckpt_dir, file_name + ".pth.gzip")


def load_checkpoint(ckpt_dir: str, file_name: str = "latest"):
    """(RecNet state dict, optimizer state or None, {'epoch', 'iter'}). The
    optimizer state is the port's {key: state} dict, or the JAX package's
    flat leaf list; `optimizer_state` turns either into the former."""
    payload = load_pth(resolve_latest(ckpt_dir, file_name))
    opt = payload.get(OPTIMIZER_KEY, payload.get(JAX_OPTIMIZER_KEY))
    meta = {"epoch": int(payload.get("epoch", 0)), "iter": int(payload.get("iter", 0))}
    # the JAX package's writer stores the 0-d BN counters with shape (1,)
    sd = {k: v.reshape(()) if k.endswith("num_batches_tracked") else v
          for k, v in payload["RecNet"].items()}
    return sd, opt, meta


def optimizer_state(saved, optimizer: str, model: torch.nn.Module, step: int):
    """A checkpoint's optimizer state, checked against `model`, as
    {parameter key: torch.optim state} for trainer.load_train_state.

    saved: the port's dict, or the JAX package's flat optax leaves (mapped
    in leaf order onto model's parameters). Raises ValueError naming the
    entry that belongs to another optimizer or whose shape differs from
    its parameter's (another model configuration)."""
    name = optimizer.lower()
    if isinstance(saved, (list, tuple)):
        return optimizer_state_from_leaves(name, saved, model.state_dict(), step)
    params = dict(model.named_parameters())
    allowed = STATE_NAMES[name]
    for key, st in saved.items():
        if key not in params:
            raise ValueError(f"optimizer state for {key!r}, which is no parameter of "
                             "the model (different model configuration?)")
        for entry, v in st.items():
            if entry not in allowed:
                raise ValueError(f"optimizer state mismatch at {key}/{entry}: not an "
                                 f"entry of {name} (different optimizer?)")
            if isinstance(v, torch.Tensor) and v.ndim and v.shape != params[key].shape:
                raise ValueError(
                    f"optimizer state mismatch at {key}/{entry}: checkpoint shape "
                    f"{tuple(v.shape)} vs expected {tuple(params[key].shape)} "
                    "(different model configuration?)")
    return saved
