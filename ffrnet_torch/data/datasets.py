"""Datasets of the port, numpy only (ffrnet_tpu/data/datasets.py; the rest
of that module waits for the port's data item)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class SyntheticPairs:
    """Procedural identities for smoke tests and benches
    (ffrnet_tpu/data/datasets.py:352-384): each identity is a fixed random
    template in [-1, 1]; a sample adds noise, and its 'masked' twin sets a
    lower-face box to -1 (a crude surgical-mask stand-in). The same seed
    gives the JAX package's samples."""

    num_identities: int = 16
    samples_per_id: int = 4
    seed: int = 0
    host_normalize: bool = True  # False: samples quantized to uint8
    noise: float = 0.05  # per-sample noise std

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.templates = rng.uniform(
            -1, 1, (self.num_identities, 112, 112, 3)).astype(np.float32)

    def __len__(self):
        return self.num_identities * self.samples_per_id

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        label = idx % self.num_identities
        img = self.templates[label] + self.noise * rng.standard_normal(
            (112, 112, 3)).astype(np.float32)
        mask = img.copy()
        mask[60:100, 20:92] = -1.0
        if not self.host_normalize:
            def q(x):  # the uint8 pixel grid
                return np.clip((x * 0.5 + 0.5) * 255.0, 0, 255).round().astype(np.uint8)
            img, mask = q(img), q(mask)
        return {"img_non": img, "img_ocl": mask, "label": np.int32(label)}
