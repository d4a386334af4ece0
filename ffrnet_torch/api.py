"""High-level facade: the one-import user API of the port.

    from ffrnet_torch.api import FFRNet

    model = FFRNet.from_pretrained("se50.pth", "FFRNet.pth")  # or .random()
    raw_emb, rect_emb = model.embed(images_nhwc)    # uint8 or [-1, 1] BGR
    scores = model.verify(img1, img2)               # rectified cosine
    acc_rect, acc_raw = model.evaluate(batches)     # full 10-fold sweep
    crops = model.align(raw_images, landmarks)      # cp2tform + warp kernels
    raw_emb, rect_emb = model.embed_files(paths, landmarks)  # decode -> embed

Counterpart of ffrnet_tpu/api.py (inference: embed / featurize / verify /
evaluate; ingest: align / embed_files). The public boundary keeps the JAX
layout: images are (N, 112, 112, 3) BGR NHWC, uint8 or [-1, 1] float,
and `featurize` returns the rectified map as NHWC (N, 7, 7, 512). Inside,
everything is NCHW.

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
from ffrnet_torch.models.quantize import (calibrate_activation_scales,
                                          calibrate_recnet_activation_scales,
                                          quantize_encoder, quantize_recnet)
from ffrnet_torch.models.recnet import RecNetConfig, build_recnet
from ffrnet_torch.ops.align import ARCFACE_REF_PTS, align_faces
from ffrnet_torch.ops.nn import images_to_unit_range
from ffrnet_torch.ops.quant import has_int8_sites

_DTYPES = (None, torch.float32, torch.bfloat16)
# the 112x112 ArcFace frame: the 96x112 reference points shifted +8 in x
REF_PTS_112 = ARCFACE_REF_PTS + np.asarray([8.0, 0.0], np.float32)


def decode_canvas(paths) -> np.ndarray:
    """Decode image files to RGB and pad them to one zero uint8 canvas
    (N, max H, max W, 3): zero pixels are the warp's border. Pillow is
    imported here only; the card's machine may lack it."""
    from PIL import Image

    imgs = [np.asarray(Image.open(p).convert("RGB"), dtype=np.uint8) for p in paths]
    canvas = np.zeros((len(imgs), max(a.shape[0] for a in imgs),
                       max(a.shape[1] for a in imgs), 3), np.uint8)
    for i, a in enumerate(imgs):
        canvas[i, :a.shape[0], :a.shape[1]] = a
    return canvas


def resolve_device(device) -> torch.device:
    """torch.device(device), raising for CUDA when there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ffrnet_torch: device='cuda' but torch.cuda.is_available() is "
            "False — pass device='cpu' to run the plain versions on the CPU")
    return dev


def forward_nhwc(encoder, recnet, dtype, x_nhwc):
    """The inference forward: (N, 112, 112, 3) [-1, 1] NHWC images -> (raw
    embedding, rectified embedding, rectified map NHWC). `FFRNet._forward`
    runs it under inference_mode; tools/export_model.py traces it."""
    x = x_nhwc.to(dtype).permute(0, 3, 1, 2).contiguous()
    featmap, raw = encoder(x)
    rect, rect_map = recnet(featmap)
    return raw, rect, rect_map.permute(0, 2, 3, 1)


class FFRNet:
    """Frozen IR-SE50 encoder + RecNet, inference only (float, or int8
    after prepare(quantize_int8=...))."""

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

    def prepare(self, *, fold_bn: bool = False, dtype=None, quantize_int8=False) -> "FFRNet":
        """A new FFRNet with the encoder's BNs folded and/or both networks
        cast to `dtype` (torch.float32 or torch.bfloat16), on the device.

        `quantize_int8` (models/quantize.py; ffrnet_tpu/api.py:69-118):
          True or "encoder": the encoder's body convs and output Linear;
          "recnet": RecNet's conv chains; "all": both.
        The order is fold, cast, quantize: the int8 scales come from the
        weights served. Activations are quantized per batch until
        `calibrate_int8` bakes static scales."""
        q_mode = "encoder" if quantize_int8 is True else quantize_int8
        if q_mode not in (False, "encoder", "recnet", "all"):
            raise ValueError(f"quantize_int8 must be False/True/'encoder'/'recnet'/'all', "
                             f"got {quantize_int8!r}")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        if fold_bn and has_int8_sites(self.encoder):
            raise ValueError(
                "prepare(fold_bn=True) on an already-int8-quantized encoder: BN folding "
                "rewrites float conv weights and cannot be applied to int8 sites. Fold before "
                "quantizing (prepare(fold_bn=True, quantize_int8=True) from a float model "
                "does both in the right order).")
        enc = fold_backbone_bn(self.encoder) if fold_bn else copy.deepcopy(self.encoder)
        rec = copy.deepcopy(self.recnet)
        enc = enc.to(device=self.device, dtype=dtype).eval()
        rec = rec.to(device=self.device, dtype=dtype).eval().collapse_channel_weights()
        if q_mode in ("encoder", "all"):
            enc = quantize_encoder(enc)
        if q_mode in ("recnet", "all"):
            rec = quantize_recnet(rec)
        model = FFRNet(enc, rec, self.cfg, self.device)
        if self.device.type == "cuda" and model.dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        return model

    def calibrate_int8(self, batches, *, margin: float = 1.0) -> "FFRNet":
        """A new FFRNet with static activation scales baked into its int8
        sites (ffrnet_tpu/api.py:120-175): no per-call amax reduce, and a
        face's embedding no longer depends on its batchmates. Activations
        beyond the calibrated range saturate at +/-127.

        `batches`: (N, 112, 112, 3) BGR images, uint8 (normalized to
        [-1, 1] first) or [-1, 1] float, host or device. One eager pass on
        the model's device; an int8 RecNet calibrates on the feature maps
        of the same batches, captured from the encoder's pass. Needs
        prepare(quantize_int8=...) first."""
        enc_q, rec_q = has_int8_sites(self.encoder), has_int8_sites(self.recnet)
        if not (enc_q or rec_q):
            raise ValueError("calibrate_int8 requires an int8-quantized model: call "
                             "prepare(quantize_int8=...) first")
        xb = [self._unit(b).to(self.dtype).permute(0, 3, 1, 2).contiguous() for b in batches]
        featmaps = []
        enc, rec = self.encoder, self.recnet
        if enc_q:
            enc = calibrate_activation_scales(enc, xb, margin=margin,
                                              capture_featmaps=featmaps if rec_q else None)
        elif rec_q:  # the float encoder gives RecNet's calibration inputs
            with torch.inference_mode():
                featmaps = [enc(x)[0] for x in xb]
        if rec_q:
            rec = calibrate_recnet_activation_scales(rec, featmaps, margin=margin)
        return FFRNet(enc, rec, self.cfg, self.device)

    # ------------------------------------------------------------- inference
    def _on_device(self, images) -> torch.Tensor:
        """NHWC images, host array or tensor -> the same type on the device."""
        x = images if isinstance(images, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(images)))
        return x.to(self.device, non_blocking=True)

    def _unit(self, images) -> torch.Tensor:
        """NHWC images, host or device -> NHWC float on the device; uint8 is
        normalized to [-1, 1] on the device (4x fewer bytes to move)."""
        x = self._on_device(images)
        return images_to_unit_range(x) if x.dtype == torch.uint8 else x

    @torch.inference_mode()
    def _forward(self, x_nhwc):
        return forward_nhwc(self.encoder, self.recnet, self.dtype, x_nhwc)

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
        """10-fold protocol over {'img1','img2','label'} batches, or packed
        {'imgs': (N, 2, H, W, 3), 'label'} ones -> (acc_rectified, acc_raw)."""
        res_new, res_raw = evaluate_pairs(self.pair_scores, batches)
        return float(res_new.mean_accuracy), float(res_raw.mean_accuracy)

    # ---------------------------------------------------------------- ingest
    def align(self, images, landmarks, *, out_hw=(112, 96), ref_pts=None) -> torch.Tensor:
        """Batched cp2tform alignment on the model's device: (N, H, W, 3)
        uint8 or float pixels and (N, 5, 2) landmarks -> float crops.

        The default crop is the (H=112, W=96) frame of the ArcFace reference
        points (lfw/gen_lfw112x96.py:8-17); for 112x112 pass
        out_hw=(112, 112) and ref_pts=REF_PTS_112. uint8 crosses to the card
        as uint8 and is cast to float32 there."""
        return align_faces(self._on_device(images), landmarks, out_hw=out_hw,
                           ref_pts=ref_pts)

    def embed_canvas(self, canvas, landmarks, *, ref_pts=REF_PTS_112):
        """Everything of `embed_files` after the decode: (N, H, W, 3) RGB
        pixels (uint8 or float, host or device) and their landmarks ->
        (raw embedding, rectified embedding, the 112x112 RGB crops).

        Aligns to 112x112 (guarded band kernel, or the full kernel), flips
        RGB -> BGR and maps to [-1, 1] as x / 127.5 - 1, then embeds."""
        crops = self.align(canvas, landmarks, out_hw=(112, 112), ref_pts=ref_pts)
        d = torch.tensor(127.5, dtype=torch.float32, device=crops.device)  # IEEE division
        raw, rect = self.embed(crops.flip(-1) / d - 1.0)
        return raw, rect, crops

    def embed_files(self, paths, landmarks) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full ingest: image files -> decode -> align on the device -> BGR
        [-1, 1] -> (raw embedding, rectified embedding).

        paths: N image files; landmarks: (N, 5, 2) pixel (x, y) points in
        each source. Sources of mixed sizes are padded to a common uint8
        canvas (`decode_canvas`), which crosses to the card as uint8.
        Alignment targets the 112x112 ArcFace frame."""
        raw, rect, _ = self.embed_canvas(decode_canvas(paths),
                                         np.asarray(landmarks, np.float32))
        return raw, rect
