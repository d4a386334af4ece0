"""Load and save `.pth` / `.pth.gzip` checkpoints through torch.

Counterpart of ffrnet_tpu/checkpoint/pth_io.py and of the unwrapping in
ffrnet_tpu/api.py::from_pretrained. The reference saves gzip-wrapped torch
pickles; `weights_only=True` keeps loading to tensors and plain containers
(dicts, lists, ints, floats): the released weights, the port's checkpoints
and the JAX package's, whose optimizer state is a list of tensors.
"""

from __future__ import annotations

import gzip
import io

import torch


def load_pth(path: str):
    """The object saved in a .pth or .pth.gzip file, tensors on the CPU."""
    opener = gzip.open if str(path).endswith(".gzip") else open
    with opener(path, "rb") as f:
        data = f.read()
    return torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)


def save_pth(obj, path: str) -> None:
    """torch.save `obj` to `path`, gzip-wrapped when it ends in .gzip. The
    gzip stream stores without compressing (level 0): float weights shrink
    by about 7% under deflate, which runs at about 20 MB/s on one core
    (seconds per checkpoint); any gzip reader reads it."""
    buf = io.BytesIO()
    torch.save(obj, buf)
    if str(path).endswith(".gzip"):
        with gzip.open(path, "wb", compresslevel=0) as f:
            f.write(buf.getvalue())
    else:
        with open(path, "wb") as f:
            f.write(buf.getvalue())


def encoder_state_dict(obj):
    """Unwrap a `{'state_dict': ...}` payload."""
    if isinstance(obj, dict) and "state_dict" in obj:
        return obj["state_dict"]
    return obj


def recnet_state_dict(obj, cfg=None):
    """Unwrap a `{'RecNet': ...}` payload and, when a cfg is given, check
    its classifier's class count against cfg.num_classes."""
    sd = obj.get("RecNet", obj) if isinstance(obj, dict) else obj
    if cfg is not None:
        cls_w = sd.get("classifier.weight")
        if cls_w is not None and cfg.num_classes != cls_w.shape[0]:
            raise ValueError(
                f"checkpoint classifier has {cls_w.shape[0]} classes but "
                f"cfg.num_classes={cfg.num_classes} — pass the matching "
                "RecNetConfig (the reference default is 10575)")
    return sd
