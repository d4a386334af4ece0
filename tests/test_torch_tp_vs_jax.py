"""The port's class-sharded train steps in gloo CPU processes against
ffrnet_tpu's pjit'd steps on the same ('data', 'model') mesh shapes of the
conftest's virtual CPU devices (ffrnet_tpu/training/trainer.py:301-392;
the JAX package's own test, tests/test_training.py:684-716).

Four ranks (tests/torch_distributed_worker.py `tp`) run
make_distributed_feature_step on a 2x2 mesh, with and without --remat (its
recompute runs the head again inside the backward pass, where the model
group's collectives must agree); two ranks run make_distributed_step
(IR-SE50, the fused configuration) on a 1x2 mesh. 13 classes padded to 14,
SGD at momentum 0 (the JAX test's setting: the update is linear in the
gradient), lr 1e-3, 2 updates on global batches of 4. Bounds, the JAX
package's: TotalLoss 1e-5 rel, TrainAcc 1e-6, the unpadded parameters
2e-5 (and the BN running stats 1e-5 abs + rel, the data axis's bound);
every other metric 1e-5 rel. The replicated parameters are bit-identical
on every rank, the classifier shards across the data axis.

The production head: 10575 classes on the 1x2 mesh, one SGD update at
momentum 0.9: shards of (5288, 512), a finite loss, and the padded row and
its momentum exactly 0.
"""

import functools
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ffrnet_torch.checkpoint.convert import (backbone_state_dict, recnet_state_dict,
                                             train_state_dicts)
from ffrnet_tpu.models import irse
from ffrnet_tpu.models.recnet import RecNetConfig as JRecNetConfig
from ffrnet_tpu.parallel.mesh import batch_sharding, make_mesh
from ffrnet_tpu.training import trainer as j_trainer
from torch_distributed_worker import join_ranks, start_ranks

NUM, GLOBAL_BATCH, STEPS = 13, 4, 2
OPTIMIZER = dict(optimizer="sgd", lr=1e-3, momentum=0.0)
PARAM_ATOL = 2e-5
STAT_TOL = dict(atol=1e-5, rtol=1e-5)
JOBS = {4: [{"name": "features", "kind": "features", "mesh": (2, 2), "num_classes": NUM,
             "cfg": OPTIMIZER, "steps": STEPS},
            {"name": "features_remat", "kind": "features", "mesh": (2, 2), "num_classes": NUM,
             "cfg": dict(OPTIMIZER, remat=True), "steps": STEPS}],
        2: [{"name": "images", "kind": "images", "mesh": (1, 2), "num_classes": NUM,
             "cfg": OPTIMIZER, "steps": STEPS},
            {"name": "production", "kind": "features", "mesh": (1, 2), "num_classes": 10575,
             "cfg": dict(OPTIMIZER, momentum=0.9), "steps": 1, "seed": 1}]}


def image_batches(seed=0):
    rng = np.random.default_rng(seed)
    return [{"img_non": rng.uniform(-1, 1, (GLOBAL_BATCH, 112, 112, 3)).astype(np.float32),
             "img_ocl": rng.uniform(-1, 1, (GLOBAL_BATCH, 112, 112, 3)).astype(np.float32),
             "label": rng.integers(0, NUM, GLOBAL_BATCH)} for _ in range(STEPS)]


def feature_batches(seed=1):
    """NHWC features (the JAX layout), unit embeddings and labels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        fm = rng.standard_normal((2, GLOBAL_BATCH, 7, 7, 512)).astype(np.float32)
        e = rng.standard_normal((2, GLOBAL_BATCH, 512)).astype(np.float32)
        e /= np.linalg.norm(e, axis=-1, keepdims=True)
        out.append({"featmap_non": fm[0], "featmap_ocl": fm[1], "embed_non": e[0],
                    "embed_ocl": e[1], "label": rng.integers(0, NUM, GLOBAL_BATCH)})
    return out


def nchw(f):
    return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2) if v.ndim == 4
                                                     else v)) for k, v in f.items()}


def _jax_run(step, st, batches, mesh, *lead):
    shard = batch_sharding(mesh)
    metrics = []
    for b in batches:
        st, m = step(*lead, st, jax.device_put({k: jnp.asarray(v) for k, v in b.items()}, shard))
        metrics.append(jax.device_get(m))
    st = jax.device_get(j_trainer.unpad_train_state_classes(st, NUM))
    return recnet_state_dict(st.params, st.model_state), metrics


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(per world size, the ranks' results; the JAX runs: per kind (state
    dict, metrics); the initial state dict)."""
    enc_p, enc_s = jax.device_get(jax.jit(irse.init)(jax.random.PRNGKey(0)))
    cfg = j_trainer.TrainerConfig(recnet=JRecNetConfig(num_classes=NUM), **OPTIMIZER)
    state = jax.device_get(jax.jit(functools.partial(j_trainer.create_train_state, cfg=cfg))(
        jax.random.PRNGKey(1)))
    images, feats = image_batches(), feature_batches()
    rec_sd, _, _ = train_state_dicts(*tuple(state), optimizer=OPTIMIZER["optimizer"])
    procs, outs = [], {}
    for world, jobs in JOBS.items():
        outs[world] = str(tmp_path_factory.mktemp(f"tp{world}"))
        torch.save({"encoder": backbone_state_dict(enc_p, enc_s), "recnet": rec_sd,
                    "jobs": jobs, "batches": [{k: torch.from_numpy(v) for k, v in b.items()}
                                              for b in images],
                    "feats": [nchw(f) for f in feats]}, os.path.join(outs[world], "inputs.pt"))
        procs += start_ranks("tp", outs[world], world=world)  # the ranks run while JAX compiles

    want = {}
    mesh = make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    fstep, st = j_trainer.make_distributed_feature_step(mesh, cfg, j_trainer.TrainState(*state))
    assert st.params["classifier"]["w"].shape == (14, 512)
    want["features"] = want["features_remat"] = _jax_run(fstep, st, feats, mesh)
    mesh = make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    step, (ep, es, st) = j_trainer.make_distributed_step(mesh, cfg, enc_p, enc_s,
                                                         j_trainer.TrainState(*state))
    want["images"] = _jax_run(step, st, images, mesh, ep, es)
    join_ranks(procs)
    got = {world: [torch.load(os.path.join(outs[world], f"tp.{r}.pt"), weights_only=False)
                   for r in range(world)] for world in JOBS}
    for out in outs.values():  # the ranks' gathered states: a few hundred MB on disk
        shutil.rmtree(out)
    return got, want, rec_sd


KINDS = {"features": 4, "features_remat": 4, "images": 2}


@pytest.mark.parametrize("kind", list(KINDS))
def test_sharded_steps_match_jax_mesh(runs, kind):
    got, want, init = runs
    sd_j, m_j = want[kind]
    res = got[KINDS[kind]][0][kind]
    sd = res["state"]
    assert sd["classifier.weight"].shape == (NUM, 512)
    for k, w in sd_j.items():
        if not w.is_floating_point():
            continue
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), err_msg=k, **STAT_TOL)
        else:
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=PARAM_ATOL, rtol=0,
                                       err_msg=k)
    moved = max((sd_j[k] - init[k]).abs().max().item() for k in sd_j if "running" not in k
                and sd_j[k].is_floating_point())
    assert moved > 10 * PARAM_ATOL  # the updates moved the weights beyond the bound
    cls_moved = (sd_j["classifier.weight"] - init["classifier.weight"]).abs().max().item()
    assert cls_moved > 10 * PARAM_ATOL  # the classifier too
    for step_t, step_j in zip(res["metrics"], m_j):
        assert set(step_t) == set(step_j)
        np.testing.assert_allclose(step_t["TotalLoss"], float(step_j["TotalLoss"]), rtol=1e-5)
        np.testing.assert_allclose(step_t["TrainAcc"], float(step_j["TrainAcc"]), atol=1e-6)
        for k in step_j:
            np.testing.assert_allclose(float(step_t[k]), float(step_j[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("kind", list(KINDS))
def test_replicas_are_bit_identical(runs, kind):
    """Every rank's replicated parameters and buffers, at every step; the
    classifier shards of one model coordinate across the data axis; the
    gathered state and the averaged metrics on every rank."""
    ranks = [g[kind] for g in runs[0][KINDS[kind]]]
    n_model = next(j["mesh"][1] for j in JOBS[KINDS[kind]] if j["name"] == kind)
    assert all(r["checksums"] == ranks[0]["checksums"] for r in ranks)
    assert len(ranks[0]["checksums"]) == STEPS
    for r, res in enumerate(ranks):
        j = r % n_model
        assert res["offset"] == 7 * j and res["shard"].shape == (7, 512)
        assert torch.equal(res["shard"], ranks[j]["shard"])  # data coordinate 0's copy
        assert res["metrics"] == ranks[0]["metrics"]
        assert res["digest"] == ranks[0]["digest"], r  # the gathered state
    # the padded row (model rank 1's last) stayed exactly zero
    assert torch.count_nonzero(ranks[n_model - 1]["shard"][-1]) == 0


def test_production_class_count(runs):
    """10575 classes on 1x2: shards of 5288 rows, a finite loss, and the
    padded row and its momentum buffer exactly 0 after the update."""
    r0, r1 = (g["production"] for g in runs[0][2])
    assert r0["shard"].shape == r1["shard"].shape == (5288, 512)
    assert (r0["offset"], r1["offset"]) == (0, 5288)
    assert np.isfinite(r0["metrics"][0]["TotalLoss"])
    assert r0["metrics"] == r1["metrics"] and r0["checksums"] == r1["checksums"]
    assert set(r1["moments"]) == {"momentum_buffer"}
    assert torch.count_nonzero(r1["shard"][-1]) == 0
    assert torch.count_nonzero(r1["moments"]["momentum_buffer"][-1]) == 0
    assert torch.count_nonzero(r1["moments"]["momentum_buffer"][:-1]) > 0
    assert r0["state"]["classifier.weight"].shape == (10575, 512)
