"""1:N identification: cosine gallery search on the device.

Counterpart of ffrnet_tpu/eval/search.py: one (P, D) x (D, G) product and
a top-k, the gallery kept on the model's device.

    gal = Gallery.build(model, enroll_images, labels)
    scores, labels = gal.search(model, probe_images, k=5)

Ties go to the lower gallery index, as `jax.lax.top_k` orders them: the
top-k is a stable descending sort (torch.topk promises no order among
equal values), and the products are summed in float64 and rounded to
float32, so two equal gallery rows score the same whatever order the
matrix product sums in. The `.npz` format is the JAX package's
(embeddings float32, labels an object array): a gallery saved by either
package loads in the other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ffrnet_torch.api import resolve_device
from ffrnet_torch.ops.nn import l2_normalize


def _cosines(probe_emb, gallery_emb) -> torch.Tensor:
    """(P, G) float32 cosines of the L2-normalized fp32 rows."""
    p = l2_normalize(probe_emb.float(), axis=1)
    g = l2_normalize(gallery_emb.float(), axis=1)
    return torch.matmul(p.double(), g.double().T).float()


def _top_k(sims, k: int):
    """(values, indices) of the k largest per row, equal values by the
    lower index."""
    vals, idx = torch.sort(sims, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def top_k_identify(probe_emb, gallery_emb, *, k: int = 1,
                   valid: Optional[int] = None):
    """Cosine top-k search. probe_emb (P, D), gallery_emb (G, D) ->
    (scores (P, k) descending, indices (P, k) into the gallery).

    Both sides are L2-normalized here, so raw and rectified embeddings
    both work. valid: rows >= valid are capacity padding and score -2
    (below any cosine)."""
    sims = _cosines(probe_emb, gallery_emb)
    if valid is not None:
        live = torch.arange(sims.shape[1], device=sims.device)[None] < valid
        sims = torch.where(live, sims, torch.full((), -2.0, device=sims.device))
    return _top_k(sims, k)


def cmc_from_embeddings(probe_emb, probe_ids, gallery_emb, gallery_ids, *,
                        max_rank: int = 10) -> torch.Tensor:
    """Cumulative match characteristic over integer identity ids ->
    (max_rank,) float32: CMC[r] = the fraction of probes whose identity is
    among the top r+1 cosine matches."""
    dev = probe_emb.device
    _, idx = _top_k(_cosines(probe_emb, gallery_emb), max_rank)  # (P, R)
    gallery_ids = torch.as_tensor(gallery_ids, device=dev)
    probe_ids = torch.as_tensor(probe_ids, device=dev)
    match = gallery_ids[idx] == probe_ids[:, None]
    hit = torch.cumsum(match.to(torch.int32), dim=1) > 0
    # XLA computes the JAX package's mean as the sum times the fp32
    # reciprocal of the count; the same keeps the CMC bit-equal
    inv = torch.tensor(1.0 / hit.shape[0], dtype=torch.float32, device=dev)
    return hit.to(torch.float32).sum(dim=0) * inv


@dataclass
class Gallery:
    """Enrolled identities: embeddings (G, D) on the device + parallel labels."""

    embeddings: Any               # (G, D) tensor
    labels: Sequence              # length G (ints or strings)

    @classmethod
    def build(cls, model, images, labels, *, rectified: bool = True,
              batch_size: int = 256) -> "Gallery":
        """Enroll aligned faces through `model` (an api.FFRNet)."""
        if len(images) != len(labels):
            raise ValueError("images and labels must be parallel")
        chunks = []
        for i in range(0, len(images), batch_size):
            raw, rect = model.embed(images[i:i + batch_size])
            chunks.append(rect if rectified else raw)
        return cls(torch.cat(chunks, dim=0), list(labels))

    def add(self, model, images, labels, *, rectified: bool = True) -> "Gallery":
        other = Gallery.build(model, images, labels, rectified=rectified)
        return Gallery(torch.cat([self.embeddings.to(other.embeddings),
                                  other.embeddings]),
                       list(self.labels) + list(other.labels))

    def save(self, path: str) -> None:
        """Persist embeddings + labels (npz): a serving restart re-enrolls
        from this instead of embedding the enrollment set again."""
        np.savez_compressed(path,
                            embeddings=self.embeddings.detach().float().cpu().numpy(),
                            labels=np.asarray(self.labels, dtype=object))

    @classmethod
    def load(cls, path: str, *, device="cuda") -> "Gallery":
        dev = resolve_device(device)
        with np.load(path, allow_pickle=True) as z:
            return cls(torch.from_numpy(z["embeddings"]).to(dev),
                       [x.item() if hasattr(x, "item") else x for x in z["labels"]])

    def cmc(self, model, probe_images, probe_labels, *, max_rank: int = 10,
            rectified: bool = True) -> np.ndarray:
        """Closed-set identification CMC of `probe_images` (with their true
        labels) against this gallery -> (max_rank,) numpy array. Labels are
        interned to ids against the gallery's label set; a probe whose
        identity is not enrolled never matches."""
        max_rank = min(max_rank, len(self.labels))
        intern = {lab: i for i, lab in enumerate(dict.fromkeys(self.labels))}
        gal_ids = [intern[lab] for lab in self.labels]
        probe_ids = [intern.get(lab, -1) for lab in probe_labels]
        raw, rect = model.embed(probe_images)
        probe = rect if rectified else raw
        return cmc_from_embeddings(probe, probe_ids, self.embeddings.to(probe.device),
                                   gal_ids, max_rank=max_rank).cpu().numpy()

    def search(self, model, probe_images, *, k: int = 1,
               rectified: bool = True) -> Tuple[torch.Tensor, list]:
        """-> (scores (P, k), labels: P lists of k gallery labels)."""
        if k > len(self.labels):
            raise ValueError(f"k={k} exceeds gallery size {len(self.labels)}")
        raw, rect = model.embed(probe_images)
        probe = rect if rectified else raw
        scores, idx = top_k_identify(probe, self.embeddings.to(probe.device), k=k)
        return scores, [[self.labels[j] for j in row] for row in idx.tolist()]
