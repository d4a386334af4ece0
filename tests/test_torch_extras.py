"""The model zoo's extras in ffrnet_torch vs ffrnet_tpu on the CPU: the
Arcface and Am_softmax heads, SELayer, HGBlock and MobileFaceNet, on the
JAX package's weights carried across by ffrnet_torch.checkpoint.convert
and numpy-seeded inputs."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ffrnet_torch.checkpoint import convert
from ffrnet_torch.models import heads as t_heads
from ffrnet_torch.models import hourglass as t_hg
from ffrnet_torch.models import mobilefacenet as t_mfn
from ffrnet_torch.models import recnet as t_recnet
from ffrnet_tpu.models import heads, hourglass, mobilefacenet

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _random_stats(state, seed):
    """The JAX state tree with every BN's running mean ~ N(0, 0.3) and
    running var ~ U(0.5, 1.5) (tests/test_parity_extras.py:19-22)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, list):
            return [walk(v) for v in t]
        if isinstance(t, dict):
            if set(t) == {"mean", "var"}:
                c = np.shape(t["mean"])
                return {"mean": rng.normal(0, 0.3, c).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
            return {k: walk(v) for k, v in t.items()}
        return t

    return walk(jax.device_get(state))


# ----------------------------------------------------------------- heads


def _head_inputs(seed, with_guard):
    """64-wide embeddings, 100 classes (tests/test_parity_extras.py); with
    the guard, rows 0-2 point away from their own class's column (cos about
    -0.95: theta + m leaves [0, pi])."""
    kernel = np.asarray(heads.init_kernel(jax.random.PRNGKey(seed), 64, 100))
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((6, 64)).astype(np.float32)
    label = rng.integers(0, 100, 6)
    if with_guard:
        for i in range(3):
            emb[i] = -kernel[:, label[i]] + 0.05 * rng.standard_normal(64).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return kernel, emb, label


@pytest.mark.parametrize("with_guard", [False, True])
@pytest.mark.parametrize("head", ["arcface", "am_softmax"])
def test_head_matches_jax(head, with_guard):
    kernel, emb, label = _head_inputs(3 if with_guard else 4, with_guard)
    j_fn = heads.arcface_logits if head == "arcface" else heads.am_softmax_logits
    want = np.asarray(j_fn(jnp.asarray(kernel), jnp.asarray(emb), jnp.asarray(label)))
    cls = t_heads.Arcface if head == "arcface" else t_heads.AmSoftmax
    module = cls(64, 100)
    module.load_state_dict(convert.head_state_dict(kernel))
    with torch.no_grad():
        got = module(torch.from_numpy(emb), torch.from_numpy(label)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if head == "arcface" and with_guard:
        cos = emb @ (kernel / np.linalg.norm(kernel, axis=0))
        assert (cos[np.arange(3), label[:3]] <= np.cos(np.pi - 0.5)).all()  # the guard ran


def test_head_init_and_reexports():
    k = t_heads.init_kernel(64, 100, generator=torch.Generator().manual_seed(0))
    assert k.shape == (64, 100) and k.abs().max() <= 1
    np.testing.assert_allclose(k.norm(dim=0).numpy(), 1.0, atol=1e-6)
    assert t_heads.add_margin_logits is t_recnet.add_margin_logits
    assert t_heads.arc_margin_logits is t_recnet.arc_margin_logits
    assert set(t_heads.Arcface(8, 5).state_dict()) == {"kernel"}
    assert t_heads.AmSoftmax(8, 5).kernel.shape == (8, 5)


# --------------------------------------------------------------- SELayer


def test_se_layer_matches_jax():
    params = jax.device_get(hourglass.init_se_layer(jax.random.PRNGKey(6), 64, 16))
    x = np.random.default_rng(2).standard_normal((2, 7, 7, 64)).astype(np.float32)
    want = np.asarray(hourglass.apply_se_layer(params, jnp.asarray(x)))
    layer = t_hg.SELayer(64, reduction=16)
    layer.load_state_dict(convert.se_layer_state_dict(params))
    with torch.no_grad():
        got = _nhwc(layer(_nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)


# --------------------------------------------------------------- HGBlock


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("shape", [
    (2, 7, 7, 16),    # 7 -> 4 -> 2 -> 4 -> 8, resized to 7 (nearest, half-pixel centres)
    (2, 16, 16, 16),  # tests/test_parity_extras.py::test_hgblock_runs
])
def test_hgblock_matches_jax(shape, training):
    params, state = hourglass.init_hgblock(jax.random.PRNGKey(0), depth=2, c_in=16, c_out=8,
                                           c_mid=12)
    params, state = jax.device_get(params), _random_stats(state, 1)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    y_j, st_j = jax.jit(functools.partial(hourglass.apply_hgblock, depth=2, training=training))(
        params, state, jnp.asarray(x))
    block = t_hg.HGBlock(2, 16, 8, c_mid=12)
    block.load_state_dict(convert.hgblock_state_dict(params, state))
    block.train(training)
    with torch.no_grad():
        y_t = block(_nchw(x))
    assert y_t.shape == (shape[0], 8, shape[1], shape[2])
    np.testing.assert_allclose(_nhwc(y_t), np.asarray(y_j), **TOL)
    if training:  # the running stats moved in place as apply's new state
        sd = block.state_dict()
        for name, s in st_j.items():
            if "mean" in s["norm"]:
                np.testing.assert_allclose(sd[f"{name}.norm.norm.running_mean"].numpy(),
                                           np.asarray(s["norm"]["mean"]), **TOL)
                np.testing.assert_allclose(sd[f"{name}.norm.norm.running_var"].numpy(),
                                           np.asarray(s["norm"]["var"]), **TOL)


def test_hgblock_keys_and_init():
    params, state = hourglass.init_hgblock(jax.random.PRNGKey(0), depth=2, c_in=16, c_out=8,
                                           c_mid=12)
    block = t_hg.HGBlock(2, 16, 8, c_mid=12)
    assert set(block.state_dict()) == set(convert.hgblock_state_dict(params, state))
    assert block.out.conv2d.bias is not None and block.b1_2.conv2d.bias is None
    t_hg.init_hgblock(block, torch.Generator().manual_seed(0))
    assert (block.b2_plus_1.relu.func.weight == 0.25).all()
    layer = t_hg.SELayer(64)
    t_hg.init_se_layer(layer, torch.Generator().manual_seed(0))
    assert set(layer.state_dict()) == {"fc.0.weight", "fc.2.weight"}
    assert layer.fc[0].weight.abs().max() <= 1 / 8  # kaiming-uniform bound sqrt(1 / 64)


# --------------------------------------------------------- MobileFaceNet


@pytest.fixture(scope="module")
def jax_mobilefacenet():
    params, state = mobilefacenet.init(jax.random.PRNGKey(0))
    return jax.device_get(params), _random_stats(state, 3)


def _port_mobilefacenet(params, state):
    model = t_mfn.build_mobilefacenet()
    model.load_state_dict(convert.mobilefacenet_state_dict(params, state))
    return model


def test_mobilefacenet_eval_matches_jax(jax_mobilefacenet):
    params, state = jax_mobilefacenet
    x = np.random.default_rng(0).uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    want, _ = jax.jit(mobilefacenet.apply)(params, state, jnp.asarray(x))
    with torch.no_grad():
        got = _port_mobilefacenet(params, state)(_nchw(x)).numpy()
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_mobilefacenet_train_matches_jax(jax_mobilefacenet):
    params, state = jax_mobilefacenet
    x = np.random.default_rng(1).uniform(-1, 1, (4, 112, 112, 3)).astype(np.float32)
    want, new_state = jax.jit(functools.partial(mobilefacenet.apply, training=True))(
        params, state, jnp.asarray(x))
    model = _port_mobilefacenet(params, state).train()
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    moved = convert.mobilefacenet_state_dict(params, jax.device_get(new_state))
    stats = [k for k in moved if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 50  # 49 BN2d and the BN1d
    for k in stats:
        np.testing.assert_allclose(sd[k], moved[k].numpy(), err_msg=k, **TOL)


def _reference_names():
    """The reference's names as tests/test_parity_extras.py:30-62 builds
    them."""
    names = set()

    def conv_block(prefix, has_prelu):
        names.update({f"{prefix}.conv.weight", f"{prefix}.bn.weight", f"{prefix}.bn.bias",
                      f"{prefix}.bn.running_mean", f"{prefix}.bn.running_var"})
        if has_prelu:
            names.add(f"{prefix}.prelu.weight")

    def dw(prefix):
        conv_block(f"{prefix}.conv", True)
        conv_block(f"{prefix}.conv_dw", True)
        conv_block(f"{prefix}.project", False)

    for name, kind, *_rest, nblocks in mobilefacenet._ARCH:
        if kind in ("conv", "linear"):
            conv_block(name, kind == "conv")
        elif kind == "dw":
            dw(name)
        else:
            for i in range(nblocks):
                dw(f"{name}.model.{i}")
    names.update({"linear.weight", "bn.weight", "bn.bias", "bn.running_mean",
                  "bn.running_var"})
    return names


def test_mobilefacenet_keys_are_the_references(jax_mobilefacenet):
    sd = t_mfn.build_mobilefacenet().state_dict()
    ours = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert ours == _reference_names()
    assert set(sd) == set(convert.mobilefacenet_state_dict(*jax_mobilefacenet))
    assert sd["conv_23.conv_dw.conv.weight"].shape == (128, 1, 3, 3)  # depthwise, OIHW
    assert sd["conv_6_dw.conv.weight"].shape == (512, 1, 7, 7)
    assert t_mfn._ARCH == mobilefacenet._ARCH


def test_build_mobilefacenet_init():
    model = t_mfn.build_mobilefacenet(128, generator=torch.Generator().manual_seed(0))
    assert not model.training and model.linear.weight.shape == (128, 512)
    assert (model.conv1.prelu.weight == 0.25).all() and (model.bn.running_var == 1).all()
    with torch.no_grad():
        out = model(torch.zeros(1, 3, 112, 112).uniform_(-1, 1))
    np.testing.assert_allclose(out.norm(dim=1).numpy(), 1.0, atol=1e-5)
