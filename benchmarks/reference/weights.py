"""Weights from a seed, drawn on the device in a few large calls: every
leaf of one distribution is a slice of one draw from one torch.Generator
on that device. A layout lists the leaves as (key, shape, kind, base,
scale): kind "uniform" is base + scale U(-1, 1), "normal" base +
scale N(0, 1), "const" the value base."""

from __future__ import annotations

import math

import torch

KINDS = ("uniform", "normal")


def draw(layout, seed: int, device) -> dict:
    """{key: float32 tensor on `device`} for `layout`, from `seed`."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = dict.fromkeys(KINDS, 0)
    for _, shape, kind, _, _ in layout:
        if kind in sizes:
            sizes[kind] += math.prod(shape)
    flat = {"uniform": torch.rand(sizes["uniform"], generator=g, device=device).mul_(2).sub_(1),
            "normal": torch.randn(sizes["normal"], generator=g, device=device)}
    at = dict.fromkeys(KINDS, 0)
    out = {}
    for key, shape, kind, base, scale in layout:
        if kind == "const":
            out[key] = torch.full(shape, float(base), device=device)
            continue
        n = math.prod(shape)
        leaf = flat[kind][at[kind]:at[kind] + n].view(shape).mul_(scale)
        out[key] = leaf.add_(base) if base else leaf
        at[kind] += n
    return out
