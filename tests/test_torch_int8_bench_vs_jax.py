"""What bench_int8_budget and bench_int8_convergence compose, held against
ffrnet_tpu on the CPU: the same weights (the port's, through ffrnet_tpu's
own torch_convert), the same int8 scales by leaf path and the same numpy
pairs.

- budget: the float reference (BN-folded encoder, RecNet in eval mode) and
  the splits' models at margin 0.75 (`split_models`, `_with_margin`),
  scored by the tool's `accuracies`;
- convergence: a checkpoint's `eval_ckpt` of a RecNet in train mode with
  running statistics of its own: the fp32 float encoder's columns, and the
  arm-consistent column of the int8 encoder `prepare_int8_encoder` makes.

The scores each tool computed are recorded through its make_pair_score_fn.
Against JAX: where the encoder is float, the whole JAX pipeline
(make_pair_score_fn of ffrnet_tpu) on the same pairs; where it is int8, the
JAX RecNet (float, or int8 with the same scales) on the feature maps the
port's int8 encoder gave, whose own parity with JAX
tests/test_torch_int8_model.py holds (XLA's int8 IR-SE50 takes about two
minutes on the CPU for these 20 faces). Float scores are held to 1e-5; an
int8 RecNet's to INT8_REC_TOL: both packages' int8 products are exact, but
a float layer an ulp apart moves an activation across a rounding point now
and then. The 10-fold accuracies each tool reports are held to JAX's
kfold_verification of the scores it computed (to 1e-5).
"""

import copy
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ffrnet_torch.data.datasets import SyntheticPairs
from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.models.optimize import fold_backbone_bn
from ffrnet_torch.models.quantize import (calibrate_activation_scales,
                                          calibrate_recnet_activation_scales, jax_leaf_path,
                                          quantize_encoder, quantize_recnet, quantized_sites)
from ffrnet_torch.models.recnet import RecNetConfig
from ffrnet_torch.tools import bench_int8_budget, bench_int8_convergence
from ffrnet_torch.tools.synth import make_eval_pairs
from ffrnet_torch.train import prepare_int8_encoder
from ffrnet_torch.training.trainer import TrainerConfig, create_train_state
from ffrnet_tpu.checkpoint.torch_convert import backbone_from_torch, recnet_from_torch
from ffrnet_tpu.eval.lfw import kfold_verification as j_kfold
from ffrnet_tpu.eval.lfw import pair_cosine as j_pair_cosine
from ffrnet_tpu.eval.runner import make_pair_score_fn as j_score_fn
from ffrnet_tpu.models import recnet as jrecnet
from ffrnet_tpu.models.optimize import fold_backbone_bn as j_fold
from ffrnet_tpu.models.quantize import quantize_recnet_params, quantized_leaf_items
from ffrnet_tpu.models.recnet import RecNetConfig as JRecNetConfig
from ffrnet_tpu.tools.bench_int8_budget import _with_margin as j_with_margin

torch.set_num_threads(1)

N_IDS, N_PAIRS, NOISE, MARGIN = 4, 10, 0.25, 0.75
FLOAT_TOL = 1e-5
INT8_REC_TOL = 1e-3  # measured 1.1e-4 at most over these pairs


def _np_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _jax_int8_rec(rec_p, port_rec, margin):
    """JAX's int8 RecNet tree with the port model's x_scales by leaf path,
    rescaled by the JAX tool's own _with_margin."""
    tree = quantize_recnet_params(rec_p)
    scales = {jax_leaf_path(p): s.x_scale.item() for p, s in quantized_sites(port_rec)}
    leaves = quantized_leaf_items(tree)
    assert len(leaves) == len(scales) == 15
    for path, leaf in leaves:
        leaf["x_scale"] = jnp.float32(scales[path])
    return j_with_margin(tree, margin)


class Recorder:
    """Stands in for a tool's make_pair_score_fn: the real one, with every
    (raw, rectified) score pair it returns kept, and the encoder's feature
    maps of each call kept by a forward hook."""

    def __init__(self, real):
        self.real, self.scores, self.fms, self.hooks = real, [], [], []

    def __call__(self, encoder, recnet):
        score = self.real(encoder, recnet)
        self.hooks.append(encoder.register_forward_hook(
            lambda m, i, o: self.fms.append(o[0].detach().permute(0, 2, 3, 1).numpy())))

        def recorded(img1, img2):
            out = score(img1, img2)
            self.scores.append(tuple(s.numpy() for s in out))
            return out

        return recorded

    def take(self):
        """-> (raw scores, rectified scores, [NHWC feature maps of each
        call's 2n faces]) since the last take; the hooks are removed."""
        raw, new = (np.concatenate(c) for c in zip(*self.scores))
        fms = self.fms
        for h in self.hooks:
            h.remove()
        self.scores, self.fms, self.hooks = [], [], []
        return raw, new, fms


@pytest.fixture(scope="module")
def world():
    """The port's encoder (seed 0) and a RecNet with running statistics of
    its own (train mode, as a training state holds it), their JAX trees, a
    dataset, and 10 eval pairs."""
    encoder = build_backbone(generator=torch.Generator().manual_seed(0))
    rec = create_train_state(TrainerConfig(recnet=RecNetConfig(num_classes=N_IDS)), seed=3,
                             device="cpu").model
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, buf in rec.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    ds = SyntheticPairs(num_identities=N_IDS, samples_per_id=4, seed=7, noise=NOISE)
    pairs = make_eval_pairs(torch.from_numpy(ds.templates), 1000, N_PAIRS, N_IDS, NOISE)
    jcfg = JRecNetConfig(num_classes=N_IDS)
    rec_p, rec_s = recnet_from_torch(_np_sd(rec), jcfg)
    return dict(encoder=encoder, rec=rec, ds=ds, pairs=pairs,
                enc_tree=backbone_from_torch(_np_sd(encoder)), rec_p=rec_p, rec_s=rec_s,
                score=j_score_fn(jcfg),
                rec_apply=jax.jit(partial(jrecnet.apply, cfg=jcfg, training=False)))


def _jax_pipeline(world, enc_tree):
    """(raw, rectified) scores of the float JAX encoder + float RecNet."""
    img1, img2, _ = (t.numpy() for t in world["pairs"])
    out = world["score"](*enc_tree, world["rec_p"], world["rec_s"], jnp.asarray(img1),
                         jnp.asarray(img2))
    return tuple(np.asarray(s) for s in out)


def _jax_rectified(world, rec_params, fms):
    """Rectified scores of the JAX RecNet (inference mode) on each call's
    feature maps of its 2n faces (img1 rows, then img2 rows)."""
    out = []
    for fm in fms:
        (f_new, _), _ = world["rec_apply"](rec_params, world["rec_s"], jnp.asarray(fm))
        n = fm.shape[0] // 2
        out.append(np.asarray(j_pair_cosine(f_new[:n], f_new[n:])))
    return np.concatenate(out)


def _jax_accs(world, raw, new):
    lab = jnp.asarray(world["pairs"][2].numpy())
    return (float(j_kfold(jnp.asarray(new), lab).mean_accuracy),
            float(j_kfold(jnp.asarray(raw), lab).mean_accuracy))


def test_budget_splits_score_as_jax(world, monkeypatch):
    """The float reference and the splits at margin 0.75, through the tool's
    split_models, _with_margin and accuracies (in two batches of 5 pairs),
    against the JAX package's models with the same scales: enc_only and
    recnet_only scored, "all" checked to pair their two int8 models."""
    rec_calls = Recorder(bench_int8_budget.make_pair_score_fn)
    monkeypatch.setattr(bench_int8_budget, "make_pair_score_fn", rec_calls)
    fenc = fold_backbone_bn(world["encoder"])
    frec = copy.deepcopy(world["rec"]).eval()
    xcal = np.stack([world["ds"].get(i, np.random.default_rng(0))["img_non"]
                     for i in range(2)])
    fms = []
    cal_enc = calibrate_activation_scales(
        quantize_encoder(fenc), [torch.from_numpy(xcal).permute(0, 3, 1, 2).contiguous()],
        capture_featmaps=fms)
    cal_rec = calibrate_recnet_activation_scales(quantize_recnet(frec), fms)
    enc_m, rec_m = (bench_int8_budget._with_margin(m, MARGIN) for m in (cal_enc, cal_rec))
    models = bench_int8_budget.split_models(fenc, frec, enc_m, rec_m)
    assert list(models) == list(bench_int8_budget.SPLITS)

    jfloat = _jax_pipeline(world, j_fold(*world["enc_tree"]))
    jrec_int8 = _jax_int8_rec(world["rec_p"], cal_rec, MARGIN)
    img1, img2, lab = world["pairs"]
    batches = [{"img1": img1[i:i + 5], "img2": img2[i:i + 5], "label": lab[i:i + 5]}
               for i in range(0, N_PAIRS, 5)]
    # "all" pairs the two int8 models that enc_only and recnet_only check
    assert models["all"] == (models["enc_only"][0], models["recnet_only"][1]) == (enc_m, rec_m)
    assert models["enc_only"][1] is frec and models["recnet_only"][0] is fenc
    for split in ("float", "enc_only", "recnet_only"):
        e, r = models.get(split, (fenc, frec))
        accs = bench_int8_budget.accuracies(e, r, batches)
        raw, new, fms = rec_calls.take()
        assert len(fms) == len(batches)
        np.testing.assert_allclose(accs, _jax_accs(world, raw, new), atol=1e-5, rtol=0,
                                   err_msg=split)
        if e is fenc:  # the float encoder: the whole JAX pipeline's raw scores
            np.testing.assert_allclose(raw, jfloat[0], atol=FLOAT_TOL, rtol=0, err_msg=split)
        if split == "float":
            np.testing.assert_allclose(new, jfloat[1], atol=FLOAT_TOL, rtol=0, err_msg=split)
        if r is rec_m:  # XLA's int8 RecNet: about 18 s a batch on the CPU, so one batch
            np.testing.assert_allclose(new[:5], _jax_rectified(world, jrec_int8, fms[:1]),
                                       atol=INT8_REC_TOL, rtol=0, err_msg=split)
        else:
            np.testing.assert_allclose(new, _jax_rectified(world, world["rec_p"], fms),
                                       atol=FLOAT_TOL, rtol=0, err_msg=split)


def test_convergence_checkpoint_scores_as_jax(world, monkeypatch):
    """eval_ckpt on a train-mode RecNet: the fp32 float encoder's columns
    against the JAX pipeline with RecNet in inference mode, and the int8
    arm's own-encoder column against the JAX RecNet on that encoder's
    feature maps; RecNet is handed back in train mode."""
    rec_calls = Recorder(bench_int8_convergence.make_pair_score_fn)
    monkeypatch.setattr(bench_int8_convergence, "make_pair_score_fn", rec_calls)
    rec = copy.deepcopy(world["rec"]).train()
    arm = prepare_int8_encoder(world["encoder"], world["ds"], "fp32", cal_images=2)
    accs = bench_int8_convergence.eval_ckpt(rec, world["encoder"], world["pairs"], arm)
    assert rec.training and len(accs) == 3
    assert len(rec_calls.scores) == 2
    (raw, new), (_, arm_new) = rec_calls.scores
    arm_fm = rec_calls.take()[2][1]

    for got, want in zip((raw, new), _jax_pipeline(world, world["enc_tree"])):
        np.testing.assert_allclose(got, want, atol=FLOAT_TOL, rtol=0)
    np.testing.assert_allclose(arm_new, _jax_rectified(world, world["rec_p"], [arm_fm]),
                               atol=FLOAT_TOL, rtol=0)
    want = _jax_accs(world, raw, new) + _jax_accs(world, raw, arm_new)[:1]
    np.testing.assert_allclose(accs, want, atol=1e-5, rtol=0)
