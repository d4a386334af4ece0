"""Load released `.pth` / `.pth.gzip` checkpoints through `torch.load`.

Counterpart of the loading half of ffrnet_tpu/checkpoint/pth_io.py and of
the unwrapping in ffrnet_tpu/api.py::from_pretrained. The reference saves
gzip-wrapped torch pickles; `weights_only=True` keeps loading to tensors
and plain containers.
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
