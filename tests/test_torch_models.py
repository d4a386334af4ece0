"""ffrnet_torch models vs ffrnet_tpu on the CPU, on the same weights.

JAX weights reach the port through ffrnet_torch.checkpoint.convert; inputs
are made with numpy from a seed and handed to both packages.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ffrnet_torch.checkpoint.convert import (backbone_state_dict,
                                             recnet_state_dict)
from ffrnet_torch.models import irse as t_irse
from ffrnet_torch.models import recnet as t_recnet
from ffrnet_torch.models.optimize import fold_backbone_bn
from ffrnet_tpu.checkpoint.torch_convert import (backbone_to_torch,
                                                 recnet_to_torch)
from ffrnet_tpu.models import irse, recnet
from ffrnet_tpu.models.optimize import fold_backbone_bn as j_fold

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


@pytest.fixture(scope="module")
def jax_encoder():
    return jax.device_get(irse.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_recnet():
    return jax.device_get(recnet.init(jax.random.PRNGKey(1)))


def _port_encoder(params, state):
    m = t_irse.build_backbone()
    m.load_state_dict(backbone_state_dict(params, state))
    return m


def _port_recnet(params, state, cfg=t_recnet.RecNetConfig()):
    m = t_recnet.build_recnet(cfg)
    m.load_state_dict(recnet_state_dict(params, state))
    return m


def _images(seed, n=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 112, 112, 3)).astype(np.float32)


def test_convert_keys_and_shapes_match_torch_convert(jax_encoder, jax_recnet):
    for ours, theirs in (
            (backbone_state_dict(*jax_encoder), backbone_to_torch(*jax_encoder)),
            (recnet_state_dict(*jax_recnet), recnet_to_torch(*jax_recnet))):
        assert set(ours) == set(theirs)
        for k, v in theirs.items():
            assert tuple(ours[k].shape) == np.shape(v), k
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_encoder_matches_jax(jax_encoder):
    params, state = jax_encoder
    x = _images(0)
    fm_j, emb_j, _ = irse.apply(params, state, jnp.asarray(x), training=False)
    model = _port_encoder(params, state)
    with torch.no_grad():
        fm_t, emb_t = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    # fp32, reassociation only (different conv algorithms): the JAX
    # package's own cross-implementation bound on embeddings is 5e-5
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), atol=5e-5)
    np.testing.assert_allclose(fm_t.permute(0, 2, 3, 1).numpy(),
                               np.asarray(fm_j), atol=5e-4, rtol=1e-4)


def test_fold_backbone_bn_matches_jax(jax_encoder):
    params, state = jax_encoder
    # non-trivial BN statistics so that the fold does real work
    rng = np.random.default_rng(3)
    state = jax.tree.map(lambda a: np.asarray(a), state)
    for us in state["body"]:
        us["res"]["bn2"]["mean"] = rng.normal(0, 0.1, us["res"]["bn2"]["mean"].shape).astype(np.float32)
        us["res"]["bn2"]["var"] = rng.uniform(0.5, 1.5, us["res"]["bn2"]["var"].shape).astype(np.float32)
    fp, fs = jax.device_get(j_fold(params, state))
    ported = fold_backbone_bn(_port_encoder(params, state))
    sd = ported.state_dict()
    ref = backbone_state_dict(fp, fs)
    assert set(sd) == set(ref)
    for k in ref:
        # same fp32 formula; sqrt/divide may round differently: 1 ulp
        np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(), rtol=2e-7,
                                   atol=1e-7, err_msg=k)
    x = _images(4, n=1)
    _, emb_j, _ = irse.apply(fp, fs, jnp.asarray(x), training=False)
    with torch.no_grad():
        _, emb_t = ported(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), atol=5e-5)


@pytest.mark.parametrize("case", ["depth", "mode", "stem_channels", "num_layers"])
def test_encoder_fail_fast(jax_encoder, case):
    params, state = jax_encoder
    if case == "depth":
        with pytest.raises(ValueError, match="residual units"):
            backbone_state_dict(params, state, num_layers=100)
    elif case == "mode":
        with pytest.raises(ValueError, match="SE blocks"):
            backbone_state_dict(params, state, mode="ir")
    elif case == "num_layers":
        sd = backbone_state_dict(params, state)
        with pytest.raises(ValueError, match="residual units"):
            t_irse.check_state_dict(sd, num_layers=152)
        with pytest.raises(ValueError, match="SE blocks"):
            t_irse.check_state_dict(sd, mode="ir")
    else:
        model = _port_encoder(params, state)
        with torch.no_grad():
            w = model.input_layer[0].weight
            model.input_layer[0].weight = torch.nn.Parameter(
                torch.nn.functional.pad(w, (0, 0, 0, 0, 0, 5)))
            x = torch.from_numpy(_images(5, n=1)).permute(0, 3, 1, 2)
            # a padded stem takes 3 channels and gives the same embedding
            _, e_pad = model(x)
            _, e_ref = _port_encoder(params, state)(x)
            np.testing.assert_allclose(e_pad.numpy(), e_ref.numpy(), atol=1e-6)
            with pytest.raises(ValueError, match="3-channel"):
                model(x[:, :1])


_CONFIGS = {
    # port config, JAX config on the XLA path
    "fused": (t_recnet.RecNetConfig(),
              recnet.RecNetConfig()),
    "factored_plain": (t_recnet.RecNetConfig(channel_impl="plain"),
                       recnet.RecNetConfig()),
    "ss_kernel": (t_recnet.SS_KERNEL_CONFIG,
                  recnet.RecNetConfig(c4c_impl="materialized")),
    "materialized_plain": (t_recnet.RecNetConfig(c4c_impl="materialized",
                                                 channel_impl="plain"),
                           recnet.RecNetConfig(c4c_impl="materialized")),
}


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_recnet_matches_jax(jax_recnet, name):
    params, state = jax_recnet
    t_cfg, j_cfg = _CONFIGS[name]
    fm = np.random.default_rng(6).standard_normal((2, 7, 7, 512)).astype(np.float32)
    (v_j, map_j), _ = recnet.apply(params, state, jnp.asarray(fm), cfg=j_cfg,
                                   training=False)
    model = _port_recnet(params, state, t_cfg)
    with torch.no_grad():
        v_t, map_t = model(torch.from_numpy(fm).permute(0, 3, 1, 2))
    # fp32 reassociation through three conv chains (the fused path also
    # accumulates without the XLA path's intermediate round trips): the
    # JAX package's own fused-vs-XLA bound is 2e-5 on the pooled vector and
    # 2e-4 on the map
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(map_t.permute(0, 2, 3, 1).numpy(),
                               np.asarray(map_j), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("channel_impl", ["fused", "plain"])
def test_recnet_collapsed_weights_cache(jax_recnet, channel_impl):
    model = _port_recnet(*jax_recnet, t_recnet.RecNetConfig(channel_impl=channel_impl))
    fm = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 512, 7, 7)).astype(np.float32))
    with torch.no_grad():
        _, want = model(fm)
        _, got = model.collapse_channel_weights()(fm)
    # the same operands computed once instead of per call: bit-equal
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_recnet_config_rejects_training_fields(jax_recnet):
    """remat_channel, a training field, is taken now that the port trains;
    it leaves the eval forward as it is. The implementation fields still
    reject values they do not know."""
    fm = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 512, 7, 7)).astype(np.float32))
    outs = []
    for remat in (False, True):
        model = _port_recnet(*jax_recnet, t_recnet.RecNetConfig(remat_channel=remat))
        with torch.no_grad():
            outs.append(model(fm)[1])
    np.testing.assert_array_equal(outs[1].numpy(), outs[0].numpy())
    with pytest.raises(ValueError, match="ss_impl"):
        t_recnet.RecNetConfig(ss_impl="pallas")


def test_golden_fixture_through_the_port(jax_encoder, jax_recnet):
    exp = np.load(os.path.join(FIXTURE, "expected.npz"))
    x = (exp["aligned"][None] / 127.5 - 1.0)[..., ::-1].astype(np.float32)
    enc = _port_encoder(*jax_encoder)
    rec = _port_recnet(*jax_recnet)
    with torch.no_grad():
        fm, raw = enc(torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2))
        rect, _ = rec(fm)
    # the bound the JAX package holds its own golden run to
    # (test_golden_e2e.py); fp32 on both sides, other conv algorithms
    np.testing.assert_allclose(raw[0].numpy(), exp["raw_embed"], atol=1e-5)
    np.testing.assert_allclose(rect[0].numpy(), exp["rect_embed"], atol=1e-5)
