"""ffrnet_torch.eval.search (1:N identification) vs ffrnet_tpu.eval.search
on the CPU: top-k, CMC, the gallery's .npz in both directions, and the
Gallery through the port's model holding the JAX model's weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ffrnet_torch.api import FFRNet as TorchFFRNet
from ffrnet_torch.checkpoint.convert import backbone_state_dict, recnet_state_dict
from ffrnet_torch.eval import search as t_search
from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.models.recnet import RecNetConfig, build_recnet
from ffrnet_tpu.api import FFRNet as JaxFFRNet
from ffrnet_tpu.eval import search as j_search

torch.set_num_threads(1)

# fp32 on both sides: the bound of tests/test_torch_api_eval.py
EMB_TOL = dict(atol=5e-5, rtol=0)
# cosines of the same fp32 rows: the port sums in float64, JAX in fp32
SCORE_TOL = dict(atol=1e-6, rtol=0)


def _rows(seed, n, d=64):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _gallery(case):
    """(probe, gallery) rows; 'ties' repeats gallery rows and probes with
    exact copies of them, so equal scores decide by index."""
    p, g = _rows(0, 7), _rows(1, 25)
    if case == "ties":
        g[[3, 9, 17]] = g[5]
        g[20] = g[2]
        p[:3] = g[[5, 2, 20]]
    return p, g


@pytest.mark.parametrize("case,k,valid", [("random", 5, None), ("random", 1, None),
                                          ("random", 16, 11), ("ties", 6, None),
                                          ("ties", 4, 18)])
def test_top_k_matches_jax(case, k, valid):
    p, g = _gallery(case)
    js, ji = j_search.top_k_identify(jnp.asarray(p), jnp.asarray(g), k=k, valid=valid)
    ts, ti = t_search.top_k_identify(torch.from_numpy(p), torch.from_numpy(g), k=k,
                                     valid=valid)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SCORE_TOL)
    if case == "ties":  # the duplicated rows come in index order
        row = ti[0].tolist()
        dup = [j for j in row if j in (3, 5, 9, 17)]
        assert dup == sorted(dup) and len(dup) >= 2
    if valid is not None:
        assert (ti < valid).sum(1).eq(min(k, valid)).all()
        assert (ts[:, valid:] == -2.0).all()


@pytest.mark.parametrize("case,max_rank", [("random", 7), ("ties", 10), ("random", 30)])
def test_cmc_matches_jax(case, max_rank):
    rng = np.random.default_rng(5)
    p, g = _rows(6, 20), _rows(7, 30)
    if case == "ties":
        g[10:20] = g[:10]
    gal_ids = np.repeat(np.arange(10), 3).astype(np.int32)
    probe_ids = rng.integers(0, 10, 20).astype(np.int32)
    want = j_search.cmc_from_embeddings(jnp.asarray(p), jnp.asarray(probe_ids), jnp.asarray(g),
                                        jnp.asarray(gal_ids), max_rank=max_rank)
    got = t_search.cmc_from_embeddings(torch.from_numpy(p), torch.from_numpy(probe_ids),
                                       torch.from_numpy(g), gal_ids, max_rank=max_rank)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_gallery_npz_both_ways(writer, tmp_path):
    emb = _rows(8, 5, 512)
    labels = ["a", "b, c", "ü", 7, "e"]
    path = str(tmp_path / "gallery.npz")
    if writer == "torch":
        t_search.Gallery(torch.from_numpy(emb), labels).save(path)
        back = j_search.Gallery.load(path)
        got = np.asarray(back.embeddings)
    else:
        j_search.Gallery(jnp.asarray(emb), labels).save(path)
        back = t_search.Gallery.load(path, device="cpu")
        assert back.embeddings.dtype == torch.float32
        got = back.embeddings.numpy()
    np.testing.assert_array_equal(got, emb)
    assert back.labels == labels


def test_gallery_load_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "g.npz")
    t_search.Gallery(torch.zeros(1, 512), ["a"]).save(path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_search.Gallery.load(path)


@pytest.fixture(scope="module")
def models():
    """The JAX package's FFRNet.random(0) and the port holding its weights."""
    jm = JaxFFRNet.random(seed=0)
    enc_p, enc_s, rec_p, rec_s = jax.device_get(
        (jm.enc_params, jm.enc_state, jm.rec_params, jm.rec_state))
    enc = build_backbone()
    enc.load_state_dict(backbone_state_dict(enc_p, enc_s))
    rec = build_recnet()
    rec.load_state_dict(recnet_state_dict(rec_p, rec_s))
    return jm, TorchFFRNet(enc, rec, RecNetConfig(), "cpu").prepare()


def test_gallery_through_the_model_matches_jax(models):
    """build / search / add / cmc on the same faces; every model call is a
    batch of 8, so the JAX side compiles one program."""
    jm, tm = models
    rng = np.random.default_rng(1)
    enroll = rng.uniform(-1, 1, (8, 112, 112, 3)).astype(np.float32)
    labels = [f"id{i}" for i in range(8)]
    jg = j_search.Gallery.build(jm, enroll, labels, batch_size=8)
    tg = t_search.Gallery.build(tm, enroll, labels, batch_size=8)
    np.testing.assert_allclose(tg.embeddings.numpy(), np.asarray(jg.embeddings), **EMB_TOL)

    probes = enroll[::-1].copy()
    js, jl = jg.search(jm, probes, k=3)
    ts, tl = tg.search(tm, probes, k=3)
    assert tl == jl and [r[0] for r in tl] == labels[::-1]
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)
    np.testing.assert_allclose(ts[:, 0].numpy(), 1.0, atol=1e-5)

    probe_labels = labels[:4] + ["ghost"] * 4
    want = jg.cmc(jm, enroll, probe_labels, max_rank=99)
    got = tg.cmc(tm, enroll, probe_labels, max_rank=99)
    assert got.shape == (8,)
    np.testing.assert_array_equal(got, want)

    # the same faces enrolled again under other labels: the same batch on
    # the CPU gives the same rows, and each face's two rows tie
    extra = [f"x{i}" for i in range(8)]
    tg2 = tg.add(tm, enroll, extra)
    assert tg2.labels == labels + extra
    assert torch.equal(tg2.embeddings[:8], tg2.embeddings[8:])
    scores, found = tg2.search(tm, enroll, k=2)
    assert torch.equal(scores[:, 0], scores[:, 1])
    assert found == [[a, b] for a, b in zip(labels, extra)]
    with pytest.raises(ValueError, match="exceeds gallery size"):
        tg.search(tm, enroll, k=9)
    with pytest.raises(ValueError, match="parallel"):
        t_search.Gallery.build(tm, enroll, labels[:-1])
