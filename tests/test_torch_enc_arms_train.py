"""bench_train's float and folded encoder arms (--enc_arms) inside the full
train step against ffrnet_tpu's train_step on the CPU: the port's seed-0
encoder (carried to JAX by ffrnet_tpu's torch_convert), one JAX RecNet
TrainState at 64 classes (carried to the port by checkpoint.convert), two
steps at N=2 on numpy-made images, fp32, driven through the duel's
`encoder_arms` and `interleaved_rounds`.

The train parity bounds (PERF.md section 2): losses 1e-4 relative,
parameters 1e-5 absolute, running stats as the losses. They hold for a
step whose update is linear in the gradient (SGD with momentum, the
tool's --optimizer sgd): the two packages' gradients agree to about 6e-5
absolute (measured: parameters 6e-8 apart after one SGD step at lr 1e-3,
1.5e-6 after two). Adam, the tool's default, divides each gradient element
by its own magnitude in its first steps, so an element whose gradient is
under that 6e-5 of noise (1% of RecNet's conv weights here) moves by up
to lr in a direction either package may pick (measured 1.4e-3 apart after
one step): under Adam the step's metrics are held to the loss bound (the
losses agree to 3e-6 after two steps) and the parameters are not compared.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffrnet_torch.checkpoint.convert import recnet_state_dict, train_state_dicts
from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.models.recnet import RecNetConfig
from ffrnet_torch.tools import bench_train
from ffrnet_torch.training.trainer import TrainerConfig, create_train_state, load_train_state
from ffrnet_tpu.checkpoint.torch_convert import backbone_from_torch
from ffrnet_tpu.models.recnet import RecNetConfig as JRecNetConfig
from ffrnet_tpu.training import trainer as j_trainer

torch.set_num_threads(1)

CLASSES = 64
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5
METRICS = ("TotalLoss", "TripletLoss", "IdentityLoss", "ClassifierLoss", "SelfSimilarityLoss",
           "PosDist", "NegDist", "TrainAcc")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX encoder params and state, the port's float and folded arms)."""
    enc = build_backbone(generator=torch.Generator().manual_seed(0))
    params, state = backbone_from_torch({k: v.numpy() for k, v in enc.state_dict().items()})
    arms, _ = bench_train.encoder_arms(
        enc, "fp32", cache_file=str(tmp_path_factory.mktemp("scales") / "scales.json"))
    return params, state, arms


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_float_and_folded_arms_match_jax_train_step(weights, optimizer):
    """Two steps (lr 1e-3, 64 classes, N=2) of the float and folded arms
    (one warm-up step and one round of one) against two of JAX's train_step
    on the float tree. Folding is exact up to rounding, so the folded arm
    is held to the float arm's bounds."""
    params, state, arms = weights
    rng = np.random.default_rng(0)
    batch = {"img_non": rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32),
             "img_ocl": rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32),
             "label": np.array([3, 41])}
    j_cfg = j_trainer.TrainerConfig(optimizer=optimizer, lr=1e-3,
                                    recnet=JRecNetConfig(num_classes=CLASSES))
    js = jax.jit(functools.partial(j_trainer.create_train_state, cfg=j_cfg))(
        jax.random.PRNGKey(1))
    js0 = jax.device_get(tuple(js))
    jstep = jax.jit(functools.partial(j_trainer.train_step, cfg=j_cfg))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        js, m_j = jstep(params, state, js, jb)
    m_j = jax.device_get(m_j)
    sd_j = recnet_state_dict(*jax.device_get((js.params, js.model_state)))

    cfg = TrainerConfig(optimizer=optimizer, lr=1e-3, recnet=RecNetConfig(num_classes=CLASSES))
    states = {k: load_train_state(create_train_state(cfg, device="cpu"),
                                  *train_state_dicts(*js0, optimizer=optimizer))
              for k in ("float", "folded")}
    steps = {k: functools.partial(bench_train.train_step, arms[k], states[k], batch, cfg=cfg)
             for k in states}
    ms, metrics = bench_train.interleaved_rounds(steps, 1, 1, device=torch.device("cpu"),
                                                 warmup=1)
    assert set(ms) == set(states)
    for k, st in states.items():
        assert st.step == 2
        for name in METRICS:
            np.testing.assert_allclose(float(metrics[k][name]), float(m_j[name]),
                                       rtol=LOSS_RTOL, atol=1e-6, err_msg=f"{k} {name}")
        if optimizer == "adam":
            continue
        sd = st.model.state_dict()
        for name, want in sd_j.items():
            got = sd[name].float().numpy()
            if "running" in name:
                np.testing.assert_allclose(got, want.numpy(), rtol=LOSS_RTOL, atol=1e-5,
                                           err_msg=f"{k} {name}")
            else:
                np.testing.assert_allclose(got, want.numpy(), atol=PARAM_ATOL, rtol=0,
                                           err_msg=f"{k} {name}")
