"""Post-training int8 quantization of the frozen IR-SE encoder and RecNet
(ffrnet_tpu/models/quantize.py).

Each quantized conv / Linear becomes an `ops.quant.Int8Site` in place of
its nn.Conv2d / nn.Linear; `ops.nn.conv2d` / `ops.nn.linear` dispatch on
it, so the forwards are those of the float models.

Encoder: the body units' conv1, conv2 and projection shortcuts (48 + 3 in
IR-SE50) and the (512, 25088) output Linear. Not the stem conv (Cin = 3,
the most sensitive layer), not the SE convs (the `se_gating` kernel stays
float), not the BN / PReLU parameters.

RecNet: the 15 conv sites of Conv4Space (c0/r0/c1/r1/c2/r2), and of
ChannelFlipMerge and Conv4Merge (conv + residual block each). Not
Conv4Channel (the fused channel branch collapses its linears) and not the
classifier.

Static activation scales come from an eager pass over calibration batches
on the model's own device: each site records the amax of its input and
runs on its dequantized float weight; then x_scale = max(amax) * margin /
127 per site.
"""

from __future__ import annotations

import copy
import re
from contextlib import contextmanager
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from ffrnet_torch.models.layers import ConvLayer
from ffrnet_torch.ops.quant import Int8Site

RECNET_INT8_SITES = ("conv4space", "flipmerge", "merge")
_RECNET_MODULES = {"conv4space": "Conv4Space", "flipmerge": "ChannelFlipMerge",
                   "merge": "Conv4Merge"}


def quantize_encoder(model: nn.Module, quantize_linear: bool = True) -> nn.Module:
    """A copy of an IR-SE Backbone with int8 body convs (and output Linear).
    Idempotent; quantize after any BN fold and dtype cast, so the scales
    come from the weights served."""
    model = copy.deepcopy(model)
    for unit in model.body:
        for seq, idx in ((unit.res_layer, 1), (unit.res_layer, 3), (unit.shortcut_layer, 0)):
            if seq is not None and not isinstance(seq[idx], Int8Site):
                seq[idx] = Int8Site(seq[idx])
    if quantize_linear and not isinstance(model.output_layer[3], Int8Site):
        model.output_layer[3] = Int8Site(model.output_layer[3])
    return model


def quantize_recnet(model: nn.Module, sites=RECNET_INT8_SITES) -> nn.Module:
    """A copy of a RecNet with the ConvLayers of `sites` int8. Idempotent."""
    model = copy.deepcopy(model)
    for site in sites:
        for m in getattr(model, _RECNET_MODULES[site]).modules():
            if isinstance(m, ConvLayer) and not isinstance(m.conv2d, Int8Site):
                m.conv2d = Int8Site(m.conv2d)
    return model


def quantized_sites(model: nn.Module) -> List[Tuple[str, Int8Site]]:
    """[(module path, site)] of every int8 site, in module order."""
    return [(name, m) for name, m in model.named_modules() if isinstance(m, Int8Site)]


_JAX_PATHS = (
    (r"body\.(\d+)\.res_layer\.1", r"body/\1/res/conv1/w"),
    (r"body\.(\d+)\.res_layer\.3", r"body/\1/res/conv2/w"),
    (r"body\.(\d+)\.shortcut_layer\.0", r"body/\1/shortcut/conv/w"),
    (r"output_layer\.3", "output/linear/w"),
    (r"Conv4Space\.([024])\.conv2d", lambda m: f"conv4space/c{int(m.group(1)) // 2}/conv/w"),
    (r"Conv4Space\.([135])\.conv([12])\.conv2d",
     lambda m: f"conv4space/r{int(m.group(1)) // 2}/conv{m.group(2)}/conv/w"),
    (r"(ChannelFlipMerge|Conv4Merge)\.0\.conv2d",
     lambda m: f"{'flipmerge' if m.group(1) == 'ChannelFlipMerge' else 'merge'}/c/conv/w"),
    (r"(ChannelFlipMerge|Conv4Merge)\.1\.conv([12])\.conv2d",
     lambda m: f"{'flipmerge' if m.group(1) == 'ChannelFlipMerge' else 'merge'}"
               f"/r/conv{m.group(2)}/conv/w"),
)


def jax_leaf_path(path: str) -> str:
    """The JAX package's leaf path (`quantized_leaf_items`) of a port site
    path: 'body.3.res_layer.1' -> 'body/3/res/conv1/w'."""
    for pat, repl in _JAX_PATHS:
        if re.fullmatch(pat, path):
            return re.sub(pat, repl, path)
    raise KeyError(f"no JAX counterpart for site {path!r}")


@contextmanager
def _fp32_exact():
    """TF32 off for cuDNN and cuBLAS while calibrating: the recorded amaxes
    come from full-precision float convolutions, as on the JAX package's
    host CPU."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _bake_static_scales(sites, run_batch, batches, *, margin: float) -> None:
    """Arm every site's amax record, run `run_batch(x)` once per batch, and
    bake x_scale = fp32(max(max(record), 1e-12) * margin / 127) into each
    site in place (ffrnet_tpu/models/quantize.py:152-193)."""
    if margin <= 0:
        # x_scale = 0 would saturate every activation at +/-127
        raise ValueError(f"margin must be positive, got {margin}")
    if any(s.x_scale is not None for s in sites):
        raise ValueError("model already has baked x_scale; re-quantize before calibrating")
    if not sites:
        raise ValueError("no quantized sites to calibrate")
    for s in sites:
        s.calibration = []
    n_batches = 0
    try:
        with torch.inference_mode(), _fp32_exact():
            for x in batches:
                run_batch(x)
                n_batches += 1
    finally:
        records = [s.calibration for s in sites]
        for s in sites:
            s.calibration = None
    if n_batches == 0:
        raise ValueError("calibration needs at least one batch")
    for s, rec in zip(sites, records):
        if len(rec) != n_batches:
            raise AssertionError(
                f"a quantized site recorded {len(rec)} amaxes over {n_batches} calibration "
                "batches: its op did not run exactly once per forward")
        s.x_scale = torch.tensor(np.float32(max(max(rec), 1e-12) * margin / 127.0),
                                 device=s.weight_q.device)


def calibrate_activation_scales(model: nn.Module, batches, *, margin: float = 1.0,
                                capture_featmaps=None) -> nn.Module:
    """A copy of an int8 Backbone with static activation scales, from NCHW
    batches in its input convention ([-1, 1] BGR, its dtype, its device).
    `capture_featmaps`: a list that receives each batch's (N, 512, 7, 7)
    feature map, RecNet's calibration inputs."""
    model = copy.deepcopy(model)

    def run(x):
        featmap, _ = model(x)
        if capture_featmaps is not None:
            capture_featmaps.append(featmap)

    _bake_static_scales([s for _, s in quantized_sites(model)], run, batches, margin=margin)
    return model


def calibrate_recnet_activation_scales(model: nn.Module, featmaps, *,
                                       margin: float = 1.0) -> nn.Module:
    """A copy of an int8 RecNet (eval mode) with static activation scales,
    from (N, 512, 7, 7) frozen-encoder feature maps."""
    model = copy.deepcopy(model)
    _bake_static_scales([s for _, s in quantized_sites(model)], model, featmaps,
                        margin=margin)
    return model
