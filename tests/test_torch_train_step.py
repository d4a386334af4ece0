"""train_step_from_features vs ffrnet_tpu on the CPU: 1 and 3 SGD updates
(momentum 0.9, lr 1e-2) at C=512, N=2, 8 classes, in the default RecNet
configuration and in SS_KERNEL_CONFIG (the JAX package's self-similarity
kernel in interpret mode, the port's Function with its plain forward),
with both ss_loss_impl. Both packages start from the same JAX TrainState,
carried across by checkpoint.convert.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ffrnet_torch.checkpoint.convert import recnet_state_dict, train_state_dicts
from ffrnet_torch.models.recnet import SS_KERNEL_CONFIG, RecNetConfig
from ffrnet_torch.training.trainer import (TrainerConfig, create_train_state,
                                           load_train_state, train_step_from_features)
from ffrnet_tpu.models.recnet import RecNetConfig as JRecNetConfig
from ffrnet_tpu.training import trainer as j_trainer

torch.set_num_threads(1)

CONFIGS = {  # name -> (port RecNetConfig, JAX RecNetConfig)
    "default": (RecNetConfig(num_classes=8), JRecNetConfig(num_classes=8)),
    "ss_kernel": (dataclasses.replace(SS_KERNEL_CONFIG, num_classes=8),
                  JRecNetConfig(num_classes=8, ss_impl="pallas", c4c_impl="materialized")),
}
SGD = dict(optimizer="sgd", lr=1e-2, momentum=0.9)


def make_features(seed=0, n=2):
    """(JAX feature dict NHWC, port feature dict NCHW) of the same numbers:
    random maps, unit embeddings, labels."""
    rng = np.random.default_rng(seed)
    fm = rng.standard_normal((2, n, 7, 7, 512)).astype(np.float32)
    e = rng.standard_normal((2, n, 512)).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    label = np.arange(n) % 8
    j = {"featmap_non": fm[0], "featmap_ocl": fm[1], "embed_non": e[0], "embed_ocl": e[1],
         "label": label}
    t = dict(j, featmap_non=fm[0].transpose(0, 3, 1, 2), featmap_ocl=fm[1].transpose(0, 3, 1, 2))
    return {k: jnp.asarray(v) for k, v in j.items()}, t


@functools.lru_cache(maxsize=None)
def initial_jax_state():
    """One fresh JAX TrainState (RecNet seed 1, SGD), shared by every
    configuration: RecNet's init and SGD's state do not depend on the
    RecNet implementation options."""
    j_cfg = j_trainer.TrainerConfig(recnet=CONFIGS["default"][1], **SGD)
    return jax.jit(functools.partial(j_trainer.create_train_state, cfg=j_cfg))(
        jax.random.PRNGKey(1))


def port_state(t_cfg, jax_state=None):
    """The port's state carried across from a JAX TrainState
    (`initial_jax_state` by default)."""
    ts = create_train_state(t_cfg, device="cpu")
    js = jax.device_get(tuple(jax_state or initial_jax_state()))
    return load_train_state(ts, *train_state_dicts(*js, optimizer=t_cfg.optimizer))


@functools.lru_cache(maxsize=None)
def jax_trajectory(name, ss_loss_impl):
    """Three JAX updates: per update (metrics, state dict, TrainState)."""
    j_cfg = j_trainer.TrainerConfig(ss_loss_impl=ss_loss_impl, recnet=CONFIGS[name][1], **SGD)
    step = jax.jit(functools.partial(j_trainer.train_step_from_features, cfg=j_cfg))
    js, feats = initial_jax_state(), make_features()[0]
    out = []
    for _ in range(3):
        js, m = step(js, feats)
        out.append((jax.device_get(m),
                    recnet_state_dict(*jax.device_get((js.params, js.model_state))), js))
    return out


@functools.lru_cache(maxsize=None)
def trajectories(name, ss_loss_impl):
    """Three updates in each package: per update (JAX metrics, JAX state
    dict, port metrics, port state dict). The ss_kernel configuration's
    loss is materialized whatever ss_loss_impl says, so its JAX run is
    shared."""
    t_cfg = TrainerConfig(ss_loss_impl=ss_loss_impl, recnet=CONFIGS[name][0], **SGD)
    j_run = jax_trajectory(name, "materialized" if name == "ss_kernel" else ss_loss_impl)
    ts, feats = port_state(t_cfg), make_features()[1]
    out = []
    for mj, sd_j, _ in j_run:
        ts, mt = train_step_from_features(ts, feats, cfg=t_cfg)
        out.append((mj, sd_j, {k: float(v) for k, v in mt.items()},
                    {k: v.clone() for k, v in ts.model.state_dict().items()}))
    return out


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("ss_loss_impl", ["factored", "materialized"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_step_from_features_matches_jax(name, ss_loss_impl, steps):
    mj, sd_j, mt, sd_t = trajectories(name, ss_loss_impl)[steps - 1]
    assert set(mt) == set(mj)
    for k in mj:
        # fp32: reassociation through the RecNet forward and the loss
        np.testing.assert_allclose(mt[k], float(mj[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    # Parameters within 1e-6 after one update. The gradient of
    # ChannelFlipMerge.0's conv weight (and of Conv4Channel behind it) is
    # ill-conditioned in fp32: feat_channel = M_channel X carries a large
    # offset common to its channels, which the BN after the conv cancels.
    # After two updates each package's fp32 gradient there strays from a
    # float64 evaluation by up to 2% of its largest entry (the port's on the
    # default path, JAX's on the materialized ones); at lr 1e-2 with
    # momentum 0.9 the parameters drift apart by a few 1e-6 over three
    # updates, and the running stats after them follow (held in the
    # one-update case and in test_jax_state_carried_across_mid_run, which
    # starts both from one state).
    atol = 1e-6 if steps == 1 else 1e-5
    for k in sd_j:
        if "running" not in k:
            np.testing.assert_allclose(sd_t[k].numpy(), sd_j[k].numpy(), atol=atol, rtol=0,
                                       err_msg=k)
        elif steps == 1:  # moved clean branch, then masked branch
            np.testing.assert_allclose(sd_t[k].numpy(), sd_j[k].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_train_step_metrics_and_state():
    """The metrics dict, the LR taken for the update, the step count, and
    fp32 masters."""
    mj, _, mt, _ = trajectories("default", "factored")[0]
    assert set(mt) == {"SelfSimilarityLoss", "TripletLoss", "IdentityLoss", "ClassifierLoss",
                       "TotalLoss", "TrainAcc", "PosDist", "NegDist", "LR"}
    assert mt["LR"] == SGD["lr"]
    cfg = TrainerConfig(recnet=CONFIGS["default"][0], **SGD)
    ts = port_state(cfg)
    assert ts.step == 0 and ts.model.training
    ts, m = train_step_from_features(ts, make_features()[1], cfg=cfg)
    assert ts.step == 1
    assert all(p.dtype == torch.float32 for p in ts.model.parameters())
    assert all(torch.isfinite(v) for k, v in m.items() if k != "LR")


def test_jax_state_carried_across_mid_run():
    """A JAX TrainState after two updates (SGD's momentum trace included)
    carried across, then the third update in each package: the same
    losses, parameters and running stats."""
    cfg = TrainerConfig(recnet=CONFIGS["default"][0], **SGD)
    run = jax_trajectory("default", "factored")
    ts = port_state(cfg, jax_state=run[1][2])
    assert ts.step == 2 and len(ts.optimizer.inner.state) == len(list(ts.model.parameters()))
    ts, mt = train_step_from_features(ts, make_features()[1], cfg=cfg)
    mj, sd_j, _ = run[2]
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    sd_t = ts.model.state_dict()
    for k in sd_j:
        if "running" in k:
            np.testing.assert_allclose(sd_t[k].numpy(), sd_j[k].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(sd_t[k].numpy(), sd_j[k].numpy(), atol=1e-6, rtol=0,
                                       err_msg=k)
