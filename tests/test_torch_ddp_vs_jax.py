"""The port's data-parallel training and eval in two gloo CPU processes
against ffrnet_tpu's pjit'd ones on a 2x1 mesh of the conftest's virtual
CPU devices.

Two ranks (tests/torch_distributed_worker.py) run make_distributed_step
and make_distributed_feature_step for two updates each on their halves of
a global batch of 4 (IR-SE50, 32 classes); the JAX package's steps take the
whole batches, which are the ranks' local batches concatenated in rank
order. After two updates RecNet's parameters and BN running stats agree
within 1e-5 and the averaged metrics within 1e-5 (rtol), and the ranks are
bit-identical. The optimizer is SGD (lr 1e-3, momentum 0.9): Adam divides
by sqrt(v), so a gradient entry that is pure rounding noise moves its
weight by up to 2 lr in either package (the JAX package's own
distributed-step test takes SGD for that reason, tests/test_training.py).
A control run with each rank's BNs on its own shard's statistics (a DDP
without SyncBatchNorm) must miss the bound: the test sees the coupling.

Then evaluate_pairs_multiprocess over 2 ranks: fold results bit-equal to
ffrnet_tpu's evaluate_pairs on the same scores, and a mis-sliced rank
makes both ranks raise the count diagnostic after the gather.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ffrnet_torch.checkpoint.convert import (backbone_state_dict, recnet_state_dict,
                                             train_state_dicts)
from ffrnet_tpu.eval.runner import evaluate_pairs as j_evaluate_pairs
from ffrnet_tpu.models import irse
from ffrnet_tpu.models.recnet import RecNetConfig as JRecNetConfig
from ffrnet_tpu.parallel.mesh import batch_sharding, make_mesh
from ffrnet_tpu.training import trainer as j_trainer
from torch_distributed_worker import join_ranks, start_ranks

NUM_CLASSES, GLOBAL_BATCH, STEPS = 32, 4, 2
OPTIMIZER = dict(optimizer="sgd", lr=1e-3, momentum=0.9)
PARAM_ATOL = 1e-5
STAT_TOL = dict(atol=1e-5, rtol=1e-5)


def image_batches(seed=0):
    rng = np.random.default_rng(seed)
    return [{"img_non": rng.uniform(-1, 1, (GLOBAL_BATCH, 112, 112, 3)).astype(np.float32),
             "img_ocl": rng.uniform(-1, 1, (GLOBAL_BATCH, 112, 112, 3)).astype(np.float32),
             "label": rng.integers(0, NUM_CLASSES, GLOBAL_BATCH)} for _ in range(STEPS)]


def feature_batches(seed=1):
    """NHWC features (the JAX layout), unit embeddings and labels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        fm = rng.standard_normal((2, GLOBAL_BATCH, 7, 7, 512)).astype(np.float32)
        e = rng.standard_normal((2, GLOBAL_BATCH, 512)).astype(np.float32)
        e /= np.linalg.norm(e, axis=-1, keepdims=True)
        out.append({"featmap_non": fm[0], "featmap_ocl": fm[1], "embed_non": e[0],
                    "embed_ocl": e[1], "label": rng.integers(0, NUM_CLASSES, GLOBAL_BATCH)})
    return out


def bn_inputs(seed=2):
    rng = np.random.default_rng(seed)
    return {"x": torch.from_numpy(rng.standard_normal((GLOBAL_BATCH, 6, 5, 5)).astype(np.float32)
                                  * 3 + 1),
            "w": torch.from_numpy(rng.standard_normal((GLOBAL_BATCH, 6, 5, 5)).astype(np.float32)),
            "scale": torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)),
            "bias": torch.from_numpy(rng.standard_normal(6).astype(np.float32))}


def nchw(f):
    return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2) if v.ndim == 4
                                                     else v)) for k, v in f.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, the JAX runs: per kind (state dict, metrics))."""
    out = str(tmp_path_factory.mktemp("steps"))
    enc_p, enc_s = jax.device_get(jax.jit(irse.init)(jax.random.PRNGKey(0)))
    cfg = j_trainer.TrainerConfig(recnet=JRecNetConfig(num_classes=NUM_CLASSES), **OPTIMIZER)
    state = jax.device_get(jax.jit(functools.partial(j_trainer.create_train_state, cfg=cfg))(
        jax.random.PRNGKey(1)))
    images, feats = image_batches(), feature_batches()
    rec_sd, opt_sd, _ = train_state_dicts(*tuple(state), optimizer=OPTIMIZER["optimizer"])
    torch.save({"encoder": backbone_state_dict(enc_p, enc_s), "recnet": rec_sd, "opt": opt_sd,
                "num_classes": NUM_CLASSES, "optimizer": OPTIMIZER,
                "batches": [{k: torch.from_numpy(v) for k, v in b.items()} for b in images],
                "feats": [nchw(f) for f in feats], "bn": bn_inputs()},
               os.path.join(out, "inputs.pt"))
    procs = start_ranks("steps", out)  # the ranks run while JAX compiles

    mesh = make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    shard = batch_sharding(mesh)
    want = {}
    step, (ep, es, st) = j_trainer.make_distributed_step(mesh, cfg, enc_p, enc_s,
                                                         j_trainer.TrainState(*state))
    metrics = []
    for b in images:
        st, m = step(ep, es, st, jax.device_put({k: jnp.asarray(v) for k, v in b.items()}, shard))
        metrics.append(jax.device_get(m))
    want["images"] = (recnet_state_dict(*jax.device_get((st.params, st.model_state))), metrics)
    fstep, st = j_trainer.make_distributed_feature_step(mesh, cfg, j_trainer.TrainState(*state))
    metrics = []
    for f in feats:
        st, m = fstep(st, jax.device_put({k: jnp.asarray(v) for k, v in f.items()}, shard))
        metrics.append(jax.device_get(m))
    want["features"] = (recnet_state_dict(*jax.device_get((st.params, st.model_state))), metrics)
    join_ranks(procs)
    got = [torch.load(os.path.join(out, f"steps.{r}.pt"), weights_only=False) for r in range(2)]
    return got, want, rec_sd


def excess(sd, want):
    """The largest amount by which a parameter or running stat of `sd`
    misses its bound against `want` (> 0: out of bound)."""
    worst = -np.inf
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        d = (sd[k].float() - w.float()).abs()
        tol = (STAT_TOL["atol"] + STAT_TOL["rtol"] * w.float().abs() if "running" in k
               else torch.full_like(d, PARAM_ATOL))
        worst = max(worst, (d - tol).max().item())
    return worst


@pytest.mark.parametrize("kind", ["images", "features"])
def test_two_rank_steps_match_jax_mesh(runs, kind):
    got, want, init = runs
    sd_j, m_j = want[kind]
    for k in sd_j:
        w, a = sd_j[k], got[0][kind]["state"][k]
        if not w.is_floating_point():
            continue
        if "running" in k:
            np.testing.assert_allclose(a.numpy(), w.numpy(), err_msg=k, **STAT_TOL)
        else:
            np.testing.assert_allclose(a.numpy(), w.numpy(), atol=PARAM_ATOL, rtol=0, err_msg=k)
    moved = max((sd_j[k] - init[k]).abs().max().item() for k in sd_j if "running" not in k
                and sd_j[k].is_floating_point())
    assert moved > 10 * PARAM_ATOL  # the updates moved the weights beyond the bound
    for step_t, step_j in zip(got[0][kind]["metrics"], m_j):
        assert set(step_t) == set(step_j)
        for k in step_j:
            np.testing.assert_allclose(float(step_t[k]), float(step_j[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("kind", ["images", "features"])
def test_ranks_are_bit_identical(runs, kind):
    a, b = (g[kind] for g in runs[0])
    assert a["checksums"] == b["checksums"] and len(a["checksums"]) == STEPS
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
    assert a["metrics"] == b["metrics"]


def test_per_rank_bn_control_misses_the_bound(runs):
    """BN statistics over each rank's 2 samples in place of the global 4:
    the running stats (and the parameters) leave the bound, and the ranks'
    running stats part."""
    got, want, _ = runs
    assert excess(got[0]["images"]["state"], want["images"][0]) <= 0
    assert excess(got[0]["per_rank_bn"]["state"], want["images"][0]) > 1e-3
    a, b = (g["per_rank_bn"]["state"] for g in got)
    assert any(not torch.equal(a[k], b[k]) for k in a if "running" in k)


def test_cross_rank_bn_gradients_match_jax(runs):
    """One train-mode BN over the 2 ranks' halves against ffrnet_tpu's
    batch_norm on the whole batch: the statistics, the running stats, and
    the gradients of sum(y^2 * w) with respect to x, scale and bias (each
    rank holds its shard's x gradient and its share of scale's and bias's,
    which sum to the whole). A BN whose all-reduces carried no gradient
    would miss the x gradient's cross-sample terms."""
    from ffrnet_tpu.ops.nn import batch_norm as j_batch_norm

    got = [g["bn"] for g in runs[0]]
    bn = bn_inputs()
    x = jnp.asarray(bn["x"].numpy().transpose(0, 2, 3, 1))
    w = jnp.asarray(bn["w"].numpy().transpose(0, 2, 3, 1))
    c = x.shape[-1]

    def loss(x, scale, bias):
        y, mean, var = j_batch_norm(x, scale, bias, jnp.zeros(c), jnp.ones(c), training=True)
        return (jnp.square(y) * w).sum(), (mean, var)

    (gx, gs, gb), (mean, var) = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(
        x, jnp.asarray(bn["scale"].numpy()), jnp.asarray(bn["bias"].numpy()))
    tol = dict(rtol=1e-5, atol=1e-5)
    gx_t = torch.cat([g["x"] for g in got]).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(gx_t, np.asarray(gx), **tol)
    np.testing.assert_allclose(sum(g["scale"] for g in got).numpy(), np.asarray(gs), **tol)
    np.testing.assert_allclose(sum(g["bias"] for g in got).numpy(), np.asarray(gb), **tol)
    for g in got:
        np.testing.assert_allclose(g["mean"].numpy(), np.asarray(mean), **tol)
        np.testing.assert_allclose(g["var"].numpy(), np.asarray(var), **tol)


def test_int8_encoder_scales_equal_across_ranks(runs):
    a, b = (g["int8_scales"] for g in runs[0])
    assert len(a) == 52 and a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_two_rank_eval_matches_jax_protocol(tmp_path):
    """600 pairs in 2 contiguous slices, scores on and off the threshold
    grid: each rank's fold results equal ffrnet_tpu's evaluate_pairs on
    the whole list, to the bit; rank 1 one pair short -> both ranks raise."""
    rng = np.random.default_rng(5)
    n = 600
    raw = rng.uniform(-1, 1, n).astype(np.float32)
    new = (rng.uniform(-1, 1, n) // 0.005 * 0.005).astype(np.float32)
    lab = rng.integers(0, 2, n).astype(np.int64)
    torch.save({"raw": raw, "new": new, "label": lab}, tmp_path / "inputs.pt")
    procs = start_ranks("eval", str(tmp_path))

    def score(e_p, e_s, r_p, r_s, img1, img2):
        return img1, img2

    batches = [{"img1": raw[s:s + 64], "img2": new[s:s + 64], "label": lab[s:s + 64]}
               for s in range(0, n, 64)]
    want = j_evaluate_pairs(None, None, None, None, batches, score_fn=score)
    join_ranks(procs)
    for r in range(2):
        res = torch.load(tmp_path / f"eval.{r}.pt", weights_only=False)
        for got, jr in zip(res["folds"], want):
            for a, b in zip(got, jr):
                np.testing.assert_array_equal(a, np.asarray(b))
        assert "per-process pair counts [300, 299] do not match" in res["mis_sliced"]
