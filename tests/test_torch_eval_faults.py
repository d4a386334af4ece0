"""Two faults of the port's eval layer, held against ffrnet_tpu on the CPU:
misclassified_indices on bf16 scores (numpy has no bf16, and a card's
tensor must come to the host first), and evaluate_pairs on packed
{'imgs': (N, 2, H, W, 3)} batches."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ffrnet_torch.eval import lfw as t_lfw
from ffrnet_torch.eval import runner as t_runner
from ffrnet_tpu.eval import lfw as j_lfw
from ffrnet_tpu.eval import runner as j_runner

N_PAIRS, BATCH = 600, 100


def _scores_labels(seed=13):
    rng = np.random.default_rng(seed)
    s = rng.uniform(-1, 1, (2, N_PAIRS)).astype(np.float32)
    labels = (rng.uniform(0, 1, N_PAIRS) < 0.5).astype(np.int32)
    return s, labels


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_misclassified_indices_of_tensors_match_jax(dtype):
    """600 seeded scores as a tensor (bf16 widens to float32 exactly): the
    same indices as the JAX package's, which takes its own arrays."""
    s, labels = _scores_labels()
    ts = torch.from_numpy(s[0]).to(getattr(torch, dtype))
    js = jnp.asarray(s[0], getattr(jnp, dtype))
    tl, jl = torch.from_numpy(labels), jnp.asarray(labels)
    res_t = t_lfw.kfold_verification(ts, tl)
    res_j = j_lfw.kfold_verification(js, jl)
    got = t_lfw.misclassified_indices(ts, tl, res_t)
    want = j_lfw.misclassified_indices(js, jl, res_j)
    assert 0 < len(want) < N_PAIRS
    np.testing.assert_array_equal(got, want)


def _index_images(n):
    """(n, 2, 1, 1, 1) float32 images whose pixel is the pair's index."""
    idx = np.arange(n, dtype=np.float32)[:, None, None, None, None]
    return np.repeat(idx, 2, axis=1)


@pytest.mark.parametrize("container", ["numpy", "torch"])
def test_evaluate_pairs_packed_batches(container):
    """Packed and two-buffer batches give bit-equal fold results, and both
    match the JAX runner (its host-side unpacking for a score_fn without a
    .packed variant) on the same scores."""
    s, labels = _scores_labels()
    imgs = _index_images(N_PAIRS)
    if container == "torch":
        imgs = torch.from_numpy(imgs)
    table = torch.from_numpy(s)

    def t_score(img1, img2):
        i = torch.as_tensor(img1).reshape(-1).long()
        assert torch.equal(i, torch.as_tensor(img2).reshape(-1).long())
        return table[0, i], table[1, i]

    def j_score(ep, es, rp, rs, img1, img2):
        i = jnp.asarray(img1).reshape(-1).astype(jnp.int32)
        return jnp.asarray(s[0])[i], jnp.asarray(s[1])[i]

    def batches(packed):
        for b in range(0, N_PAIRS, BATCH):
            lab = labels[b:b + BATCH]
            if packed:
                yield {"imgs": imgs[b:b + BATCH], "label": lab}
            else:
                yield {"img1": imgs[b:b + BATCH, 0], "img2": imgs[b:b + BATCH, 1],
                       "label": lab}

    packed = t_runner.evaluate_pairs(t_score, batches(True))
    two = t_runner.evaluate_pairs(t_score, batches(False))
    for rp, r2 in zip(packed, two):
        for a, b in zip(rp, r2):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = j_runner.evaluate_pairs(None, None, None, None, batches(True), score_fn=j_score)
    for got, ref in zip(packed, want):
        np.testing.assert_array_equal(got.fold_accuracies.numpy(),
                                      np.asarray(ref.fold_accuracies))
        np.testing.assert_array_equal(got.best_thresholds.numpy(),
                                      np.asarray(ref.best_thresholds))
        # the mean of 10 fp32 values may be summed in another order
        assert float(got.mean_accuracy) == pytest.approx(float(ref.mean_accuracy), abs=1e-7)
