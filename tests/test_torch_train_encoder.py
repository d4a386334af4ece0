"""train_step with the frozen IR-SE50 encoder at N=2, and bf16 mixed
precision, vs ffrnet_tpu on the CPU (one SGD update, lr 1e-2, no momentum,
8 classes). Weights cross by checkpoint.convert; inputs are made with numpy
from a seed.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ffrnet_torch.checkpoint.convert import (backbone_state_dict, recnet_state_dict,
                                             train_state_dicts)
from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.models.recnet import RecNetConfig
from ffrnet_torch.training.trainer import (TrainerConfig, create_train_state, encode_frozen,
                                           load_train_state, train_step,
                                           train_step_from_features)
from ffrnet_tpu.models import irse
from ffrnet_tpu.models.recnet import RecNetConfig as JRecNetConfig
from ffrnet_tpu.training import trainer as j_trainer

torch.set_num_threads(1)

SGD = dict(optimizer="sgd", lr=1e-2, momentum=0.0)


@pytest.fixture(scope="module")
def jax_states():
    """(IR-SE50 params and state, a fresh RecNet TrainState), host trees."""
    cfg = j_trainer.TrainerConfig(recnet=JRecNetConfig(num_classes=8), **SGD)
    enc = jax.jit(irse.init)(jax.random.PRNGKey(0))
    ts = jax.jit(functools.partial(j_trainer.create_train_state, cfg=cfg))(
        jax.random.PRNGKey(1))
    return jax.device_get(enc), jax.device_get(tuple(ts))


def _port(jax_states, compute_dtype):
    (enc_p, enc_s), js = jax_states
    cfg = TrainerConfig(compute_dtype=compute_dtype, recnet=RecNetConfig(num_classes=8), **SGD)
    state = create_train_state(cfg, device="cpu")
    load_train_state(state, *train_state_dicts(*js, optimizer="sgd"))
    encoder = build_backbone()
    encoder.load_state_dict(backbone_state_dict(enc_p, enc_s))
    return cfg, state, encoder


def _batch(seed=0, n=2):
    rng = np.random.default_rng(seed)
    return {"img_non": rng.integers(0, 256, (n, 112, 112, 3), dtype=np.uint8),
            "img_ocl": rng.integers(0, 256, (n, 112, 112, 3), dtype=np.uint8),
            "label": np.array([1, 6])}


def _compare(m_t, m_j, sd_t, sd_j, loss_rtol, param_atol, stat_atol=1e-5):
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=loss_rtol, atol=1e-6,
                                   err_msg=k)
    for k in sd_j:
        if "running" in k:
            np.testing.assert_allclose(sd_t[k].float().numpy(), sd_j[k].numpy(), rtol=loss_rtol,
                                       atol=stat_atol, err_msg=k)
        else:
            np.testing.assert_allclose(sd_t[k].float().numpy(), sd_j[k].numpy(), atol=param_atol,
                                       rtol=0, err_msg=k)


def test_train_step_with_encoder_matches_jax(jax_states):
    """uint8 images through both encoders (normalized on the device), one
    2N pass, then one update. The packed 'imgs' layout gives the same
    features."""
    (enc_p, enc_s), js = jax_states
    cfg, state, encoder = _port(jax_states, "fp32")
    batch = _batch()
    j_cfg = j_trainer.TrainerConfig(recnet=JRecNetConfig(num_classes=8), **SGD)
    new_js, m_j = jax.jit(functools.partial(j_trainer.train_step, cfg=j_cfg))(
        enc_p, enc_s, j_trainer.TrainState(*js), {k: jnp.asarray(v) for k, v in batch.items()})
    state, m_t = train_step(encoder, state, batch, cfg=cfg)
    sd_j = recnet_state_dict(*jax.device_get((new_js.params, new_js.model_state)))
    # fp32: the train step's own bounds (test_torch_train_step.py)
    _compare(m_t, m_j, state.model.state_dict(), sd_j, loss_rtol=1e-5, param_atol=1e-6)
    packed = {"imgs": np.stack([batch["img_non"], batch["img_ocl"]], axis=1),
              "label": batch["label"]}
    a, b = encode_frozen(encoder, batch), encode_frozen(encoder, packed)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="compute_dtype"):
        train_step(encoder, state, batch, cfg=TrainerConfig(compute_dtype="bf16", **SGD))


def test_bf16_matches_jax(jax_states):
    """compute_dtype='bf16': a bf16 copy of the fp32 masters runs the step,
    whose gradient reaches the masters; BN statistics, running stats, the
    loss reductions and the optimizer stay fp32. Bounds: bf16 rounds each
    activation at 8 mantissa bits (2^-8 relative) through about 20 layers
    in each package, at other points (losses and running stats 1e-2
    relative); the update lr * g moves each parameter by at most 1e-2, and
    its bf16 error stays under a tenth of that; a running mean moves by 0.1
    of a batch mean, and the two packages' bf16 convolutions put those means
    up to about 4e-2 apart (measured 3.3e-2; 2^-8 of outputs that reach
    about 10), so the running means within 5e-3."""
    _, js = jax_states
    cfg, state, _ = _port(jax_states, "bf16")
    rng = np.random.default_rng(3)
    fm = rng.standard_normal((2, 2, 7, 7, 512)).astype(np.float32)
    e = rng.standard_normal((2, 2, 512)).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    feats_j = {"featmap_non": fm[0], "featmap_ocl": fm[1], "embed_non": e[0], "embed_ocl": e[1]}
    feats_j = {k: jnp.asarray(v, jnp.bfloat16) for k, v in feats_j.items()}
    feats_j["label"] = jnp.asarray([2, 5])
    j_cfg = j_trainer.TrainerConfig(compute_dtype="bf16", recnet=JRecNetConfig(num_classes=8),
                                    **SGD)
    new_js, m_j = jax.jit(functools.partial(j_trainer.train_step_from_features, cfg=j_cfg))(
        j_trainer.TrainState(*js), feats_j)
    feats_t = {"featmap_non": fm[0].transpose(0, 3, 1, 2), "featmap_ocl": fm[1].transpose(0, 3, 1, 2),
               "embed_non": e[0], "embed_ocl": e[1], "label": np.array([2, 5])}
    state, m_t = train_step_from_features(state, feats_t, cfg=cfg)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(b.dtype == torch.float32 for n, b in state.model.named_buffers() if "running" in n)
    sd_j = recnet_state_dict(*jax.device_get((new_js.params, new_js.model_state)))
    _compare(m_t, m_j, state.model.state_dict(), sd_j, loss_rtol=1e-2, param_atol=1e-3,
             stat_atol=5e-3)
