"""The port's tools/synth.py against ffrnet_tpu/tools/synth.py on the CPU.

The two packages draw their noise and labels from different generators
(JAX's PRNG keys, torch's Philox), so their batches differ; what must
agree is the generative model: SyntheticPairs' templates (bit-equal), the
occluder region, the unpainted clean images, the label halves and the
distinct identities of the negative pairs, checked at noise 0 on both
packages' outputs alike, and the noise level."""

import numpy as np
import pytest
import torch

import jax

from ffrnet_tpu.data.datasets import SyntheticPairs as JaxSyntheticPairs
from ffrnet_tpu.tools import synth as jsynth
from ffrnet_torch.data.datasets import SyntheticPairs
from ffrnet_torch.tools import synth

N_IDS = 5


@pytest.fixture(scope="module")
def templates():
    t = SyntheticPairs(num_identities=N_IDS, seed=7).templates
    np.testing.assert_array_equal(t, JaxSyntheticPairs(num_identities=N_IDS, seed=7).templates)
    return t


def _ours_batch(templates, key, batch, noise):
    b = synth.make_batch_fn(torch.from_numpy(templates), batch, N_IDS, noise)(key)
    return {k: v.numpy() for k, v in b.items()}


def _jax_batch(templates, key, batch, noise):
    b = jsynth.make_batch_fn(jax.numpy.asarray(templates), batch, N_IDS, noise)(
        jax.random.PRNGKey(key))
    return {k: np.asarray(v) for k, v in b.items()}


def _ours_pairs(templates, key, n_pairs, noise=0.0):
    return tuple(t.numpy() for t in synth.make_eval_pairs(torch.from_numpy(templates), key,
                                                          n_pairs, N_IDS, noise))


def _jax_pairs(templates, key, n_pairs, noise=0.0):
    return tuple(np.asarray(t) for t in jsynth.make_eval_pairs(
        jax.numpy.asarray(templates), jax.random.PRNGKey(key), n_pairs, N_IDS, noise))


def _outside_mask(img):
    keep = np.ones(img.shape[1:3], bool)
    keep[synth.MASK] = False
    return img[:, keep]


def _identity(img, templates):
    """Each row's identity: the template it equals outside the mask."""
    out = []
    for row in _outside_mask(img):
        hits = [i for i, t in enumerate(_outside_mask(templates)) if np.array_equal(row, t)]
        assert len(hits) == 1
        out.append(hits[0])
    return np.array(out)


def test_templates_bit_equal_and_mask_is_syntheticpairs(templates):
    assert synth.MASK == jsynth.MASK == (slice(60, 100), slice(20, 92))
    # SyntheticPairs.get paints the same region
    s = SyntheticPairs(num_identities=N_IDS, seed=7, noise=0.0).get(0, np.random.default_rng(0))
    painted = synth.occlude(torch.from_numpy(s["img_non"][None])).numpy()[0]
    np.testing.assert_array_equal(painted, s["img_ocl"])


@pytest.mark.parametrize("draw", [_ours_batch, _jax_batch], ids=["torch", "jax"])
def test_noise_free_batch_structure(templates, draw):
    b = draw(templates, 3, 12, 0.0)
    lab = b["label"]
    assert lab.shape == (12,) and lab.min() >= 0 and lab.max() < N_IDS
    np.testing.assert_array_equal(b["img_non"], templates[lab])  # not painted
    ocl = b["img_ocl"]
    assert (ocl[:, synth.MASK[0], synth.MASK[1], :] == -1.0).all()
    np.testing.assert_array_equal(_outside_mask(ocl), _outside_mask(templates[lab]))


def test_labels_are_int64_and_images_float32(templates):
    b = synth.make_batch_fn(torch.from_numpy(templates), 4, N_IDS, 0.25)(0)
    assert b["label"].dtype == torch.int64
    assert b["img_non"].dtype == b["img_ocl"].dtype == torch.float32
    assert b["img_non"].shape == (4, 112, 112, 3)


def test_occlude_paints_a_copy():
    """img_non is the unpainted image: the paint must not reach its input."""
    x = torch.zeros(2, 112, 112, 3)
    y = synth.occlude(x)
    assert (x == 0).all()
    assert (y[:, 60:100, 20:92] == -1).all() and y.sum() == -2 * 40 * 72 * 3


@pytest.mark.parametrize("draw", [_ours_pairs, _jax_pairs], ids=["torch", "jax"])
def test_noise_free_eval_pairs_structure(templates, draw):
    for key in range(12):
        img1, img2, lab = draw(templates, key, 8)
        np.testing.assert_array_equal(lab, [1] * 4 + [0] * 4)
        a, b = _identity(img1, templates), _identity(img2, templates)
        np.testing.assert_array_equal(img1, templates[a])  # img1 clean
        assert (img2[:, synth.MASK[0], synth.MASK[1], :] == -1.0).all()  # img2 masked
        np.testing.assert_array_equal(a[:4], b[:4])
        assert (a[4:] != b[4:]).all()


@pytest.mark.parametrize("draw", [_ours_batch, _jax_batch], ids=["torch", "jax"])
def test_noise_std(templates, draw):
    b = draw(templates, 1, 16, 0.25)
    std = float((b["img_non"] - templates[b["label"]]).std())
    assert abs(std - 0.25) <= 0.02 * 0.25


def test_one_key_one_batch(templates):
    t = torch.from_numpy(templates)
    make = synth.make_batch_fn(t, 6, N_IDS, 0.25)
    a, b, c = make(11), make(11), make(12)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["img_non"], c["img_non"])
    p, q = synth.make_eval_pairs(t, 5, 10, N_IDS, 0.25), synth.make_eval_pairs(t, 5, 10, N_IDS,
                                                                                0.25)
    for x, y in zip(p, q):
        assert torch.equal(x, y)
