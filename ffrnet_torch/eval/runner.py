"""Evaluation runner: batched pair embedding + on-device verification.

Counterpart of ffrnet_tpu/eval/runner.py. Each pair batch goes through the
encoder and RecNet as one 2N batch; the scores stay on the device through
the loop and the 10-fold sweep runs there too, so the host waits for the
device only once, when the results are copied at the end.

Multi-process (`evaluate_pairs_multiprocess`): each rank scores its
contiguous `process_pair_slice` of the pair list; the host scores are
gathered in rank order over the host group (gloo: NCCL gathers no host
tensors) and every rank runs the same fold sweep.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable

import numpy as np
import torch

from ffrnet_torch.eval.lfw import kfold_verification


def make_pair_score_fn(encoder, recnet) -> Callable:
    """(img1, img2) -> (raw scores, rectified scores): both sides in one 2N
    pass through `encoder` and `recnet`, NHWC images (uint8 normalized on
    the device) moved to the encoder's device. Both modules must be in
    eval mode (RecNet's BNs then use their running stats)."""
    from ffrnet_torch.api import FFRNet

    return FFRNet(encoder, recnet, recnet.cfg, encoder.input_layer[0].weight.device).pair_scores


def _score_batches(score_fn: Callable, batches: Iterable):
    """(raw score, rectified score, label) chunks, one of each per batch;
    a packed 'imgs' batch is split into imgs[:, 0] and imgs[:, 1]."""
    raw_chunks, new_chunks, labels = [], [], []
    for batch in batches:
        if "imgs" in batch:
            s_raw, s_new = score_fn(batch["imgs"][:, 0], batch["imgs"][:, 1])
        else:
            s_raw, s_new = score_fn(batch["img1"], batch["img2"])
        raw_chunks.append(s_raw)
        new_chunks.append(s_new)
        labels.append(torch.as_tensor(batch["label"]))
    return raw_chunks, new_chunks, labels


def evaluate_pairs(score_fn: Callable, batches: Iterable, *, return_scores: bool = False):
    """Full verification protocol over {'img1', 'img2', 'label'} batches,
    or packed {'imgs': (N, 2, H, W, 3), 'label'} ones, split here into
    imgs[:, 0] and imgs[:, 1].

    score_fn(img1, img2) -> (scores_raw, scores_rect) on the device, e.g.
    `FFRNet.pair_scores` or `make_pair_score_fn`. Returns (result_rect,
    result_raw) on the host, rectified first as in the reference's
    get_avg_accuracy; with return_scores also (scores_rect, scores_raw,
    labels) as host numpy arrays (they feed the misclassified-pair dumps).
    """
    raw_chunks, new_chunks, labels = _score_batches(score_fn, batches)
    if not raw_chunks:
        raise ValueError("evaluate_pairs got no batches — empty pair list "
                         "or exhausted iterator?")
    s_new, s_raw = torch.cat(new_chunks), torch.cat(raw_chunks)
    lab = torch.cat(labels).to(s_raw.device)
    results = tuple(type(r)(*(t.cpu() for t in r))
                    for r in (kfold_verification(s_new, lab), kfold_verification(s_raw, lab)))
    if return_scores:
        return results + (s_new.float().cpu().numpy(), s_raw.float().cpu().numpy(),
                          lab.cpu().numpy())
    return results


def process_pair_slice(n_pairs: int, process_index: int = 0, process_count: int = 1) -> slice:
    """The contiguous block of the pair list that process `process_index`
    of `process_count` scores (the folds are contiguous ranges, so the
    blocks gathered in process order give the protocol's pair order); the
    remainder goes one pair each to the lowest process ids."""
    base, rem = divmod(n_pairs, process_count)
    start = process_index * base + min(process_index, rem)
    return slice(start, start + base + (1 if process_index < rem else 0))


def _all_gather_host(payload: torch.Tensor, group) -> list:
    """Every rank's (same-shape) host tensor, in rank order; this process's
    alone outside a process group."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return [payload]
    out = [torch.empty_like(payload) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, payload, group=group)
    return out


def evaluate_pairs_multiprocess(score_fn: Callable, local_batches: Iterable, *, n_pairs: int,
                                return_scores: bool = False):
    """The verification protocol over a pair list split across the
    processes of the process group (ffrnet_tpu/eval/runner.py:160-236;
    one process outside a group): each process scores the batches of its
    own process_pair_slice(n_pairs); the scores, labels and the
    count each process saw are gathered in process order, and the fold
    sweep runs identically on every process, which all return the same
    (result_rect, result_raw) as `evaluate_pairs` over the whole list
    (with return_scores, also the gathered host arrays).

    A process may own no pair; it still joins the gather. Each payload is
    cut or zero-padded to the largest slice first, so a mis-sliced process
    enters the gather with the agreed shape, and the count check raises
    after it, on every process: raising before it would leave the others
    waiting in the collective."""
    from ffrnet_torch import parallel

    process_count = parallel.world_size()
    raw_chunks, new_chunks, labels = _score_batches(score_fn, local_batches)
    device = raw_chunks[0].device if raw_chunks else torch.device("cpu")
    sizes = [len(range(n_pairs)[process_pair_slice(n_pairs, p, process_count)])
             for p in range(process_count)]
    cap = max(sizes)
    # one float64 row per process: raw, rect and label (exact in float64),
    # then the count
    local = torch.zeros((3, cap), dtype=torch.float64)
    count = 0
    if raw_chunks:
        cols = [torch.cat(raw_chunks).float().cpu(), torch.cat(new_chunks).float().cpu(),
                torch.cat(labels).cpu()]
        count = cols[0].shape[0]
        for i, c in enumerate(cols):
            local[i, :min(count, cap)] = c[:cap].double()
    payload = torch.cat([local.reshape(-1), torch.tensor([count], dtype=torch.float64)])
    gathered = _all_gather_host(payload, parallel.host_group())
    counts = [int(g[-1]) for g in gathered]
    if counts != sizes:
        raise ValueError(
            f"per-process pair counts {counts} do not match the "
            f"owned process_pair_slice sizes {sizes} of {n_pairs} (feed "
            "batches over process_pair_slice)")  # on every process alike
    rows = [g[:-1].reshape(3, cap)[:, :sizes[p]] for p, g in enumerate(gathered)]
    s_raw, s_new, lab = torch.cat(rows, dim=1)
    s_raw, s_new = s_raw.float().to(device), s_new.float().to(device)
    lab = lab.long().to(device)
    results = tuple(type(r)(*(t.cpu() for t in r))
                    for r in (kfold_verification(s_new, lab), kfold_verification(s_raw, lab)))
    if return_scores:
        return results + (s_new.cpu().numpy(), s_raw.cpu().numpy(), lab.cpu().numpy())
    return results


def save_wrong_images(dataset, wrong_idx, out_dir: str) -> int:
    """Write each misclassified pair as {idx:04d}_1.png / _2.png under
    out_dir (the reference's save_wrong_imgs). The dataset gives
    {'img1', 'img2'} BGR, uint8 or [-1, 1]; pass one with flip_prob 0 for
    reproducible dumps. Returns the number of files written."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    written = 0
    for i in np.asarray(wrong_idx).ravel():
        sample = dataset.get(int(i), rng)
        for key, suffix in (("img1", "_1"), ("img2", "_2")):
            if sample[key].dtype == np.uint8:
                rgb = sample[key][:, :, ::-1]
            else:
                bgr = np.clip(sample[key] * 0.5 + 0.5, 0.0, 1.0)
                rgb = (bgr[:, :, ::-1] * 255.0).round().astype(np.uint8)
            Image.fromarray(np.ascontiguousarray(rgb)).save(
                os.path.join(out_dir, f"{int(i):04d}{suffix}.png"))
            written += 1
    return written
