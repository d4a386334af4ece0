"""The port's eval_lfw against ffrnet_tpu's on the CPU with the real
IR-SE50 and RecNet (the port's random init, carried to the JAX package by
its torch converters), on the lfw_tree fixture: bit-equal fold
accuracies at ocl 0, 1 and 2."""

import numpy as np
import pytest
import torch

from ffrnet_torch import train as train_mod
from ffrnet_torch.config import Options
from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.models.recnet import RecNetConfig, build_recnet
from ffrnet_tpu import train as j_train
from ffrnet_tpu.checkpoint.torch_convert import backbone_from_torch, recnet_from_torch
from ffrnet_tpu.config import Options as JOptions

torch.set_num_threads(2)

CLASSES = 8


@pytest.fixture(scope="module")
def weights():
    """(JAX encoder trees, JAX RecNet trees, port encoder, port RecNet): the
    port's random init (seeds 0 and 1) carried to the JAX package by its
    own torch converters."""
    p_enc = build_backbone(generator=torch.Generator().manual_seed(0))
    p_rec = build_recnet(RecNetConfig(num_classes=CLASSES),
                         generator=torch.Generator().manual_seed(1))
    enc = backbone_from_torch({k: v.numpy() for k, v in p_enc.state_dict().items()})
    rec = recnet_from_torch({k: v.numpy() for k, v in p_rec.state_dict().items()})
    return enc, rec, p_enc.eval(), p_rec.train()


def test_eval_lfw_fold_accuracies_bit_equal_jax(lfw_tree, weights, monkeypatch):
    """eval_lfw at ocl 0, 1 and 2 in both packages: the same mean
    accuracies, fold accuracies and thresholds (bit-equal), the scores
    within 1e-5 (the port's RecNet comes in and goes out in train mode)."""
    root, pairs = lfw_tree
    enc, rec, p_enc, p_rec = weights
    kw = dict(test_data=str(root), test_pair_list=str(pairs), batch_size=30, n_thread=2,
              num_classes=CLASSES)
    opts = Options(device="cpu", **kw).finalize(make_dirs=False)
    jopts = JOptions(**kw).finalize(make_dirs=False)
    seen = {"port": [], "jax": []}

    def recording(real, side):
        def run(*args, **kwargs):
            out = real(*args, **dict(kwargs, return_scores=True))
            seen[side].append(out)
            return out
        return run

    monkeypatch.setattr(train_mod, "evaluate_pairs", recording(train_mod.evaluate_pairs, "port"))
    monkeypatch.setattr(j_train, "evaluate_pairs", recording(j_train.evaluate_pairs, "jax"))
    for ocl in (0, 1, 2):
        got = train_mod.eval_lfw(opts, p_enc, p_rec, ocl)
        assert p_rec.training
        assert got == j_train.eval_lfw(jopts, enc, rec, ocl, jopts.trainer_config())
    assert len(seen["port"]) == len(seen["jax"]) == 3
    for res, jres in zip(seen["port"], seen["jax"]):
        for r, jr in zip(res[:2], jres[:2]):
            np.testing.assert_array_equal(r.fold_accuracies.numpy(),
                                          np.asarray(jr.fold_accuracies))
            np.testing.assert_array_equal(r.best_thresholds.numpy(),
                                          np.asarray(jr.best_thresholds))
        for s, js in zip(res[2:4], jres[2:4]):
            assert s.shape == (60,)
            np.testing.assert_allclose(s, np.asarray(js), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(res[4], np.asarray(jres[4]))
