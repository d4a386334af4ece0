"""LFW verification protocol (10-fold threshold sweep) on the device.

Counterpart of ffrnet_tpu/eval/lfw.py, with the same numerics, so that the
fold accuracies and thresholds are bit-equal on identical scores:

  * pair cosine with a 1e-8 denominator epsilon
  * contiguous folds; a remainder that does not fill the folds is dropped
  * threshold grid arange(-1, 1, 0.005); for sub-f64 scores the f64 grid is
    rounded DOWN to f32 (`_T32`), which keeps the strict `>` exact
  * per fold, the LAST best threshold on the training pairs (the
    reference's `>=` tie-break), then accuracy on the held-out fold
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

N_FOLDS = 10
THRESHOLD_START = -1.0
THRESHOLD_STEP = 0.005
N_THRESHOLDS = 400

# For any f32 score s and t32 = largest f32 <= t64: (s > t64) <=> (s > t32).
_T64 = np.arange(THRESHOLD_START, 1.0, THRESHOLD_STEP)
_T32 = _T64.astype(np.float32)
_T32 = np.where(_T32.astype(np.float64) > _T64,
                np.nextafter(_T32, np.float32(-np.inf)), _T32)


def pair_cosine(f1, f2, *, eps: float = 1e-8):
    """Cosine similarity per row pair."""
    dot = torch.sum(f1 * f2, dim=1)
    n1 = torch.sqrt(torch.sum(f1 * f1, dim=1))
    n2 = torch.sqrt(torch.sum(f2 * f2, dim=1))
    return dot / (n1 * n2 + eps)


class FoldResult(NamedTuple):
    mean_accuracy: torch.Tensor    # scalar
    fold_accuracies: torch.Tensor  # (n_folds,)
    best_thresholds: torch.Tensor  # (n_folds,)


def kfold_verification(scores, labels, *, n_folds: int = N_FOLDS) -> FoldResult:
    """10-fold threshold-sweep verification as one reduction on the scores'
    device. scores: (N,) pair cosines; labels: (N,), nonzero = same person."""
    n = scores.shape[0]
    per_fold = n // n_folds
    if per_fold == 0:
        raise ValueError(
            f"kfold_verification needs at least n_folds={n_folds} pairs, "
            f"got {n}")
    n_used = per_fold * n_folds
    scores = scores[:n_used]
    labels = labels[:n_used].to(scores.device)
    # the f32 grid serves every sub-f64 score type: a bf16 score widens to
    # f32 exactly, so the round-down construction stays exact
    if scores.dtype == torch.float64:
        thresholds = torch.from_numpy(_T64).to(scores.device)
    else:
        thresholds = torch.from_numpy(_T32).to(scores.device)
        scores = scores.float()
    pred = scores[None, :] > thresholds[:, None]            # (T, N)
    correct = pred == (labels[None, :] > 0)                 # (T, N)
    fold_correct = correct.reshape(N_THRESHOLDS, n_folds, per_fold).sum(-1)
    train_correct = correct.sum(-1, keepdim=True) - fold_correct  # (T, F)
    # the last argmax along the thresholds: argmax of the reversed axis
    # returns the first maximum
    best_idx = N_THRESHOLDS - 1 - torch.argmax(train_correct.flip(0), dim=0)
    folds = torch.arange(n_folds, device=scores.device)
    # XLA compiles the JAX version's `/ per_fold` to a multiply by the fp32
    # reciprocal; doing the same keeps the fold accuracies bit-equal
    inv = torch.tensor(1.0 / per_fold, dtype=torch.float32, device=scores.device)
    fold_acc = fold_correct[best_idx, folds].to(torch.float32) * inv
    return FoldResult(mean_accuracy=fold_acc.mean(), fold_accuracies=fold_acc,
                      best_thresholds=thresholds[best_idx])


def _host(a):
    """A numpy array of `a` on the host. A tensor may lie on the card or be
    of a type numpy lacks: bf16 and fp16 widen to float32, exactly."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.float()
        return a.numpy()
    return np.asarray(a)


def misclassified_indices(scores, labels, result: FoldResult, *,
                          n_folds: int = N_FOLDS):
    """Global indices of pairs misclassified by their own fold's threshold
    (host-side numpy; feeds image dumps). Scores, labels and the result may
    be tensors on the card, in bf16 too."""
    scores = _host(scores)
    labels = _host(labels) > 0
    thresholds = _host(result.best_thresholds)
    per_fold = scores.shape[0] // n_folds
    n_used = per_fold * n_folds
    fold_of = np.arange(n_used) // per_fold
    pred = scores[:n_used] > thresholds[fold_of]
    return np.nonzero(pred != labels[:n_used])[0]


def exact_roc(scores, labels):
    """Exact ROC from the empirical scores (host-side numpy): (fpr, tpr)
    ascending in FPR, including (0, 0) and (1, 1), ties collapsed."""
    scores = np.asarray(scores, np.float64)
    pos = np.asarray(labels) > 0
    n_pos = max(int(pos.sum()), 1)
    n_neg = max(int((~pos).sum()), 1)
    order = np.argsort(-scores, kind="stable")
    s, p = scores[order], pos[order]
    tp = np.cumsum(p)
    fp = np.cumsum(~p)
    last_of_tie = np.r_[s[1:] != s[:-1], True]
    tpr = np.r_[0.0, tp[last_of_tie] / n_pos]
    fpr = np.r_[0.0, fp[last_of_tie] / n_neg]
    return fpr, tpr


def tar_at_far(scores, labels, far_targets=(1e-3, 1e-2)):
    """TAR at the given FARs, interpolated on the exact ROC."""
    fpr, tpr = exact_roc(np.asarray(scores), np.asarray(labels))
    return {float(f): float(np.interp(f, fpr, tpr)) for f in far_targets}


def roc_metrics(scores, labels, far_targets=(1e-3, 1e-2, 1e-1)):
    """{"tar@far": {far: tar}, "eer": e, "auc": a} from the exact ROC."""
    fpr, tpr = exact_roc(scores, labels)
    tar = {float(f): float(np.interp(f, fpr, tpr)) for f in far_targets}
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    auc = float(trapezoid(tpr, fpr))
    diff = (1.0 - tpr) - fpr  # FNR - FPR, decreasing along the curve
    k = int(np.searchsorted(-diff, 0.0))
    if k == 0:
        eer = float(fpr[0])
    elif k >= len(fpr):
        eer = float(fpr[-1])
    else:
        d0, d1 = diff[k - 1], diff[k]
        t = 0.0 if d0 == d1 else d0 / (d0 - d1)
        eer = float(fpr[k - 1] + t * (fpr[k] - fpr[k - 1]))
    return {"tar@far": tar, "eer": eer, "auc": auc}
