"""Evaluation runner: batched pair embedding + on-device verification.

Counterpart of ffrnet_tpu/eval/runner.py::evaluate_pairs. Each pair batch
goes through the encoder and RecNet as one 2N batch; the scores stay on the
device through the loop and the 10-fold sweep runs there too, so the host
waits for the device only once, when the results are copied at the end.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from ffrnet_torch.eval.lfw import kfold_verification


def evaluate_pairs(score_fn: Callable, batches: Iterable):
    """Full verification protocol over {'img1', 'img2', 'label'} batches,
    or packed {'imgs': (N, 2, H, W, 3), 'label'} ones, split here into
    imgs[:, 0] and imgs[:, 1].

    score_fn(img1, img2) -> (scores_raw, scores_rect) on the device, e.g.
    `FFRNet.pair_scores`. Returns (result_rect, result_raw) on the host,
    rectified first as in the reference's get_avg_accuracy.
    """
    raw_chunks, new_chunks, labels = [], [], []
    for batch in batches:
        if "imgs" in batch:
            s_raw, s_new = score_fn(batch["imgs"][:, 0], batch["imgs"][:, 1])
        else:
            s_raw, s_new = score_fn(batch["img1"], batch["img2"])
        raw_chunks.append(s_raw)
        new_chunks.append(s_new)
        labels.append(torch.as_tensor(batch["label"]).to(s_raw.device,
                                                          non_blocking=True))
    if not raw_chunks:
        raise ValueError("evaluate_pairs got no batches — empty pair list "
                         "or exhausted iterator?")
    lab = torch.cat(labels)
    results = (kfold_verification(torch.cat(new_chunks), lab),
               kfold_verification(torch.cat(raw_chunks), lab))
    return tuple(type(r)(*(t.cpu() for t in r)) for r in results)
