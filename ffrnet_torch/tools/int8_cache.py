"""A file cache of the bench configurations' int8 static activation scales
(ffrnet_tpu/tools/int8_cache.py).

The scales are a function of the weights, the calibration batch and its
dtype, so the duel tools keep them in `.int8_scales_torch.json` at the
repo root (listed in .gitignore; the JAX package's `.int8_scales.json` is
its own and is never written here), keyed by leaf path: the JAX package's
'/'-joined trail of the site (models/quantize.py::jax_leaf_path, e.g.
"body/3/res/conv1/w"). The file format is the JAX package's current one,
{"entries": {key: {leaf_path: scale}}}, so a file written by either
package resolves in the other. A renamed, added or removed site shows as a
path-set mismatch: the entry is stale and is recalibrated, never shifted
onto other sites.

A key names a fingerprint of the weights (`weights_fingerprint`: every
parameter and buffer of the models the scales depend on), so a change to
the init, the BN fold, the dtype or the quantizer gives a new key and a
miss, never another model's scales.

What became of the JAX tool's relay workarounds: calibration runs on the
model's own device (models/quantize.py switches TF32 off while it runs);
the JAX tool moved every calibration to the host CPU because eager
dispatch through its relay was slow. Its readers of legacy positional
lists are not ported: they can only match the JAX package's own keys,
which no port key equals. Not a user-facing mechanism: real deployments
calibrate once with `FFRNet.calibrate_int8`.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os

import numpy as np
import torch

from ffrnet_torch.models.quantize import (calibrate_activation_scales,
                                          calibrate_recnet_activation_scales, jax_leaf_path,
                                          quantized_sites)

STATUS_HIT = "hit"
STATUS_MISS = "miss (calibrated + saved)"
STATUS_STALE = "stale (recalibrated + saved)"


def default_cache_file() -> str:
    """.int8_scales_torch.json at the repo root (three levels up)."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".int8_scales_torch.json")


def weights_fingerprint(*models: torch.nn.Module) -> str:
    """16 hex digits of a SHA-256 over the models' parameters and buffers:
    names, dtypes, shapes and bytes, in state_dict order."""
    h = hashlib.sha256()
    for model in models:
        for name, t in model.state_dict().items():
            t = t.detach().cpu().contiguous()
            h.update(f"{name}:{t.dtype}:{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def encoder_cache_key(qmodel: torch.nn.Module, *, dtype_name: str, cal_batch: int = 8,
                      seed: int = 2) -> str:
    """The key of an int8 encoder's (no x_scale yet) scales; never a JAX key
    (`prng0-...`)."""
    return (f"torch-enc-w{weights_fingerprint(qmodel)}-{dtype_name}"
            f"-cal{cal_batch}xseed{seed}-v2")


def recnet_cache_key(qrec: torch.nn.Module, encoder: torch.nn.Module, *, dtype_name: str,
                     cal_batch: int = 8, seed: int = 2) -> str:
    """The key of an int8 RecNet's (no x_scale yet) scales. Its calibration
    feature maps come from `encoder`, so that encoder's weights are part of
    the fingerprint."""
    return (f"torch-recnet-w{weights_fingerprint(qrec, encoder)}-{dtype_name}"
            f"-cal{cal_batch}xseed{seed}-v2")


def load_scales(cache_file: str, key: str):
    """The {leaf_path: scale} dict cached under `key`, or None."""
    if not os.path.exists(cache_file):
        return None
    with open(cache_file) as f:
        return json.load(f).get("entries", {}).get(key)


def save_scales(cache_file: str, key: str, scales_by_path) -> None:
    """Merge-save a {leaf_path: scale} dict, keeping the other keys; a
    corrupt file is replaced."""
    entries = {}
    if os.path.exists(cache_file):
        try:
            with open(cache_file) as f:
                entries = dict(json.load(f).get("entries", {}))
        except (json.JSONDecodeError, OSError):
            entries = {}
    entries[key] = {str(p): float(s) for p, s in scales_by_path.items()}
    with open(cache_file, "w") as f:
        json.dump({"entries": entries}, f)


def _walk_key(path: str):
    # the JAX walk: sorted dict keys, list indices in index order
    return tuple(int(c) if c.isdigit() else c for c in path.split("/"))


def quantized_leaf_items(model: torch.nn.Module):
    """[(JAX leaf path, Int8Site)] in the JAX package's walk order
    (ffrnet_tpu/models/quantize.py:76-102), not named_modules() order, so
    the two packages list a model's sites alike."""
    return sorted(((jax_leaf_path(name), site) for name, site in quantized_sites(model)),
                  key=lambda item: _walk_key(item[0]))


def _resolve_cached(cached, tree_items):
    """`cached` ({leaf_path: scale} from load_scales) when it covers exactly
    the model's sites (`tree_items`, quantized_leaf_items of the model),
    else None: the entry is stale."""
    return cached if set(cached) == {p for p, _ in tree_items} else None


def _rehydrate(qmodel: torch.nn.Module, by_path) -> torch.nn.Module:
    """A copy of `qmodel` with each site's x_scale = fp32(scale) by path."""
    out = copy.deepcopy(qmodel)
    items = quantized_leaf_items(out)
    if len(items) != len(by_path):
        raise ValueError(f"scale cache/site count mismatch: {len(by_path)} scales for "
                         f"{len(items)} sites")
    for path, site in items:
        site.x_scale = torch.tensor(np.float32(by_path[path]), device=site.weight_q.device)
    return out


def _cached_or_calibrated(qmodel, cache_file, cache_key, calibrate):
    """(model with baked scales, status): the cache entry when it resolves,
    else `calibrate()`'s scales, saved under `cache_key`."""
    cached = load_scales(cache_file, cache_key)
    by_path = None if cached is None else _resolve_cached(cached, quantized_leaf_items(qmodel))
    if by_path is not None:
        return _rehydrate(qmodel, by_path), STATUS_HIT
    by_path = {p: float(s.x_scale) for p, s in quantized_leaf_items(calibrate())}
    save_scales(cache_file, cache_key, by_path)
    return _rehydrate(qmodel, by_path), STATUS_STALE if cached is not None else STATUS_MISS


def uniform_faces(n: int, seed: int, dtype, device) -> torch.Tensor:
    """(n, 3, 112, 112) images, default_rng(seed) uniform [-1, 1] drawn NHWC
    in float32, cast to `dtype` on `device`: the cache's calibration batch
    (seed 2) and bench_int8's held-out input (seed 1)."""
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 112, 112, 3))
    return torch.from_numpy(x.astype(np.float32)).to(device, dtype).permute(
        0, 3, 1, 2).contiguous()


def static_encoder_tree(qmodel, dtype, *, cache_file: str, cache_key: str,
                        cal_batch: int = 8, seed: int = 2):
    """-> (a copy of the int8 encoder `qmodel` (no x_scale yet) with static
    scales, cache status). On a miss or a stale entry the scales are
    calibrated on the model's device and saved under `cache_key`."""
    dev = qmodel.input_layer[0].weight.device
    return _cached_or_calibrated(
        qmodel, cache_file, cache_key,
        lambda: calibrate_activation_scales(
            qmodel, [uniform_faces(cal_batch, seed, dtype, dev)]))


def static_recnet_tree(qrec, enc_fwd, dtype, *, cache_file: str, cache_key: str,
                       cal_batch: int = 8, seed: int = 2):
    """-> (a copy of the int8 RecNet `qrec` (eval mode, no x_scale yet) with
    static scales, cache status). `enc_fwd(x)` maps NCHW images to the
    (N, 512, 7, 7) feature maps RecNet calibrates on."""
    dev = qrec.classifier.weight.device

    def calibrate():
        with torch.inference_mode():
            fm = enc_fwd(uniform_faces(cal_batch, seed, dtype, dev))
        return calibrate_recnet_activation_scales(qrec, [fm.to(dtype)])

    return _cached_or_calibrated(qrec, cache_file, cache_key, calibrate)
