"""Synthetic identities drawn on the device (ffrnet_tpu/tools/synth.py).

The generative model is data/datasets.py::SyntheticPairs': a fixed
uniform[-1, 1] template per identity plus gaussian noise per sample, and a
masked twin with SyntheticPairs' occluder region painted to -1. The
templates go to the device once; each batch is drawn there from a
torch.Generator seeded with the batch's key, so a long loop moves no batch
from the host. The JAX module did the same to spare its relay the uploads;
here it also keeps the host's normal draws (what bounds
tools/bench_driver.py) out of the loop.

One key gives one batch on one device. The Philox streams of the CPU and
CUDA generators differ, so a key gives another batch on the card than on
the CPU, and neither is the JAX package's batch: the templates are
bit-equal to it (SyntheticPairs' numpy draws), the noise is not.

Used by bench_int8_budget (protocol-delta eval pairs) and
bench_int8_convergence (the train stream and the checkpoint eval pairs).
"""

from __future__ import annotations

import torch

MASK = (slice(60, 100), slice(20, 92))  # SyntheticPairs' occluder region


def occlude(img: torch.Tensor) -> torch.Tensor:
    """A copy of NHWC `img` with the SyntheticPairs mask region set to -1
    (the JAX `.at[].set` is functional: `img` itself stays unpainted)."""
    out = img.clone()
    out[:, MASK[0], MASK[1], :] = -1.0
    return out


def make_batch_fn(templates: torch.Tensor, batch: int, n_ids: int, noise: float):
    """-> make_batch(key: int) -> {'img_non', 'img_ocl', 'label'}: `batch`
    NHWC float32 images on the templates' device (N, 112, 112, 3) and int64
    labels, drawn from a generator seeded with `key`."""

    def make_batch(key: int):
        dev = templates.device
        gen = torch.Generator(device=dev).manual_seed(int(key))
        labels = torch.randint(0, n_ids, (batch,), generator=gen, device=dev)
        img = templates[labels] + noise * torch.randn((batch, 112, 112, 3), generator=gen,
                                                      device=dev)
        return {"img_non": img, "img_ocl": occlude(img), "label": labels}

    return make_batch


def make_eval_pairs(templates: torch.Tensor, key: int, n_pairs: int, n_ids: int,
                    noise: float):
    """ocl-1 verification pairs -> (img1, img2, labels) on the templates'
    device: img1 clean, img2 masked (the rectified branch has to earn its
    accuracy); the first half share an identity (label 1), the second half
    have different ones (label 0)."""
    dev = templates.device
    gen = torch.Generator(device=dev).manual_seed(int(key))
    half = n_pairs // 2
    a_same = torch.randint(0, n_ids, (half,), generator=gen, device=dev)
    a_diff = torch.randint(0, n_ids, (half,), generator=gen, device=dev)
    b_diff = (a_diff + 1 + torch.randint(0, n_ids - 1, (half,), generator=gen,
                                         device=dev)) % n_ids
    i1 = torch.cat([a_same, a_diff])
    i2 = torch.cat([a_same, b_diff])
    labels = torch.cat([torch.ones(half, dtype=torch.int64, device=dev),
                        torch.zeros(half, dtype=torch.int64, device=dev)])
    shape = (half * 2, 112, 112, 3)
    img1 = templates[i1] + noise * torch.randn(shape, generator=gen, device=dev)
    img2 = occlude(templates[i2] + noise * torch.randn(shape, generator=gen, device=dev))
    return img1, img2, labels
