"""High-level facade: the one-import user API of the port.

    from ffrnet_torch.api import FFRNet

    model = FFRNet.from_pretrained("se50.pth", "FFRNet.pth")  # or .random()
    raw_emb, rect_emb = model.embed(images_nhwc)    # uint8 or [-1, 1] BGR
    scores = model.verify(img1, img2)               # rectified cosine
    acc_rect, acc_raw = model.evaluate(batches)     # full 10-fold sweep

Counterpart of ffrnet_tpu/api.py (inference: embed / featurize / verify /
evaluate). The public boundary keeps the JAX layout: images are
(N, 112, 112, 3) BGR NHWC, uint8 or [-1, 1] float, and `featurize`
returns the rectified map as NHWC (N, 7, 7, 512). Inside, everything is
NCHW.

Entry points default to device="cuda" and raise when there is no card;
the CPU runs only when the caller asks for it (device="cpu"), and then
every kernel wrapper takes its plain twin.

Numerics: cuDNN runs fp32 convolutions in TF32 by default (about three
decimal digits). A model prepared in fp32 on the card switches TF32 off
for cuDNN and cuBLAS (`torch.backends.cudnn.allow_tf32` and
`torch.backends.cuda.matmul.allow_tf32`, both process-wide), so fp32
means fp32.
"""

from __future__ import annotations

import copy
from typing import Iterable, Tuple

import numpy as np
import torch

from ffrnet_torch.checkpoint.pth_io import (encoder_state_dict, load_pth,
                                            recnet_state_dict)
from ffrnet_torch.eval.lfw import pair_cosine
from ffrnet_torch.eval.runner import evaluate_pairs
from ffrnet_torch.models.irse import build_backbone, check_state_dict
from ffrnet_torch.models.optimize import fold_backbone_bn
from ffrnet_torch.models.recnet import RecNetConfig, build_recnet
from ffrnet_torch.ops.nn import images_to_unit_range

_DTYPES = (None, torch.float32, torch.bfloat16)


def resolve_device(device) -> torch.device:
    """torch.device(device), raising for CUDA when there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ffrnet_torch: device='cuda' but torch.cuda.is_available() is "
            "False — pass device='cpu' to run the plain versions on the CPU")
    return dev


class FFRNet:
    """Frozen IR-SE50 encoder + RecNet, inference only."""

    def __init__(self, encoder, recnet, cfg: RecNetConfig, device):
        self.encoder = encoder
        self.recnet = recnet
        self.cfg = cfg
        self.device = torch.device(device)

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder.input_layer[0].weight.dtype

    # ------------------------------------------------------------------ init
    @classmethod
    def random(cls, seed: int = 0, *, cfg: RecNetConfig = RecNetConfig(),
               dtype=None, device="cuda", fold_bn: bool = False) -> "FFRNet":
        """Random weights from `seed` (encoder) and `seed + 1` (RecNet)."""
        dev = resolve_device(device)
        enc = build_backbone(generator=torch.Generator().manual_seed(seed))
        rec = build_recnet(cfg, generator=torch.Generator().manual_seed(seed + 1))
        return cls(enc, rec, cfg, dev).prepare(fold_bn=fold_bn, dtype=dtype)

    @classmethod
    def from_pretrained(cls, encoder_path: str, recnet_path: str = "", *,
                        cfg: RecNetConfig = RecNetConfig(), fold_bn: bool = True,
                        dtype=None, device="cuda") -> "FFRNet":
        """Load released .pth / .pth.gzip weights (reference key schema)."""
        dev = resolve_device(device)
        if recnet_path:
            rec = build_recnet(cfg)
            rec.load_state_dict(recnet_state_dict(load_pth(recnet_path), cfg))
        else:
            rec = build_recnet(cfg, generator=torch.Generator().manual_seed(0))
        enc_sd = encoder_state_dict(load_pth(encoder_path))
        check_state_dict(enc_sd)
        enc = build_backbone()
        enc.load_state_dict(enc_sd)
        return cls(enc, rec, cfg, dev).prepare(fold_bn=fold_bn, dtype=dtype)

    def prepare(self, *, fold_bn: bool = False, dtype=None) -> "FFRNet":
        """A new FFRNet with the encoder's BNs folded and/or both networks
        cast to `dtype` (torch.float32 or torch.bfloat16), on the device."""
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        enc = fold_backbone_bn(self.encoder) if fold_bn else copy.deepcopy(self.encoder)
        rec = copy.deepcopy(self.recnet)
        enc = enc.to(device=self.device, dtype=dtype).eval()
        rec = rec.to(device=self.device, dtype=dtype).eval().collapse_channel_weights()
        model = FFRNet(enc, rec, self.cfg, self.device)
        if self.device.type == "cuda" and model.dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        return model

    # ------------------------------------------------------------- inference
    def _unit(self, images) -> torch.Tensor:
        """NHWC images, host or device -> NHWC float on the device; uint8 is
        normalized to [-1, 1] on the device (4x fewer bytes to move)."""
        x = images if isinstance(images, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(images)))
        x = x.to(self.device, non_blocking=True)
        return images_to_unit_range(x) if x.dtype == torch.uint8 else x

    @torch.inference_mode()
    def _forward(self, x_nhwc):
        x = x_nhwc.to(self.dtype).permute(0, 3, 1, 2).contiguous()
        featmap, raw = self.encoder(x)
        rect, rect_map = self.recnet(featmap)
        return raw, rect, rect_map.permute(0, 2, 3, 1)

    def embed(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, 112, 112, 3) BGR -> (raw embedding (N, 512) L2-normed,
        rectified embedding (N, 512))."""
        raw, rect, _ = self._forward(self._unit(images))
        return raw, rect

    def featurize(self, images):
        """(raw_embed, rectified_embed, rectified map NHWC (N, 7, 7, 512))."""
        return self._forward(self._unit(images))

    def pair_scores(self, img1, img2):
        """(raw, rectified) cosine per pair, both sides in ONE 2N batch.
        Each side is normalized on its own, so a mixed uint8/float pair
        speaks [-1, 1] on both sides."""
        n = len(img1)
        if n != len(img2):
            raise ValueError(
                f"verify() needs the same number of images on each side, "
                f"got {n} vs {len(img2)}")
        both = torch.cat([self._unit(img1), self._unit(img2)], dim=0)
        raw, rect, _ = self._forward(both)
        return pair_cosine(raw[:n], raw[n:]), pair_cosine(rect[:n], rect[n:])

    def verify(self, img1, img2, *, rectified: bool = True) -> torch.Tensor:
        """Per-pair cosine scores (the reference's verification distance)."""
        s_raw, s_rect = self.pair_scores(img1, img2)
        return s_rect if rectified else s_raw

    def evaluate(self, batches: Iterable) -> Tuple[float, float]:
        """10-fold protocol over {'img1','img2','label'} batches ->
        (acc_rectified, acc_raw)."""
        res_new, res_raw = evaluate_pairs(self.pair_scores, batches)
        return float(res_new.mean_accuracy), float(res_raw.mean_accuracy)
