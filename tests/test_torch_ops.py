"""ffrnet_torch.ops.nn and models.layers vs ffrnet_tpu on the CPU, plus the
port's import rules (no JAX, nothing of ffrnet_tpu)."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ffrnet_torch.models import layers as t_layers
from ffrnet_torch.ops import nn as t_ops
from ffrnet_tpu.models import layers as j_layers
from ffrnet_tpu.ops import nn as j_ops

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rng(seed=0):
    return np.random.default_rng(seed)


def _nhwc_to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nchw_to_nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("norm", ["batch_norm", "batch_norm_bf16", "instance_norm",
                                  "group_norm", "pixel_norm", "layer_norm"])
def test_norms_match_jax(norm):
    r = _rng(1)
    x = r.standard_normal((2, 5, 5, 64)).astype(np.float32)
    scale = r.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = r.normal(0, 0.1, 64).astype(np.float32)
    mean = r.normal(0, 0.1, 64).astype(np.float32)
    var = r.uniform(0.5, 1.5, 64).astype(np.float32)
    T = torch.from_numpy
    tol = dict(atol=1e-5, rtol=1e-5)  # fp32, different reduction order
    if norm.startswith("batch_norm"):
        dt_j, dt_t = (jnp.bfloat16, torch.bfloat16) if norm.endswith("bf16") else (
            jnp.float32, torch.float32)
        want, _, _ = j_ops.batch_norm(jnp.asarray(x, dt_j), scale, bias, mean, var,
                                      training=False)
        got = t_ops.batch_norm(_nhwc_to_nchw(x).to(dt_t), T(scale), T(bias), T(mean),
                               T(var))
        if norm.endswith("bf16"):  # same bf16 rounding points; 1 bf16 ulp
            tol = dict(atol=1e-2, rtol=1e-2)
        got = got.float()
        want = np.asarray(want, np.float32)
    else:
        args = () if norm == "pixel_norm" else (scale, bias)
        want = np.asarray(getattr(j_ops, norm)(jnp.asarray(x), *args))
        got = getattr(t_ops, norm)(_nhwc_to_nchw(x), *map(T, args))
    np.testing.assert_allclose(_nchw_to_nhwc(got), want, **tol)


@pytest.mark.parametrize("act", ["prelu_nchw", "prelu_rows", "leaky_relu", "relu"])
def test_activations_match_jax(act):
    r = _rng(2)
    x = r.standard_normal((2, 8, 3, 3)).astype(np.float32)
    if act == "prelu_nchw":
        slope = r.uniform(0, 0.5, 8).astype(np.float32)
        want = j_ops.prelu(jnp.asarray(x.transpose(0, 2, 3, 1)), slope, axis=-1)
        got = t_ops.prelu(torch.from_numpy(x), torch.from_numpy(slope), axis=1)
        np.testing.assert_array_equal(_nchw_to_nhwc(got), np.asarray(want))
        return
    if act == "prelu_rows":  # Conv4Channel: slopes over dim 1 of (N, 512, 32)
        x3 = r.standard_normal((2, 512, 32)).astype(np.float32)
        slope = r.uniform(0, 0.5, 512).astype(np.float32)
        want = j_ops.prelu(jnp.asarray(x3), slope, axis=1)
        got = t_ops.prelu(torch.from_numpy(x3), torch.from_numpy(slope), axis=1)
    else:
        want = getattr(j_ops, act)(jnp.asarray(x))
        got = getattr(t_ops, act)(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("op", ["reflect_pad", "stride_pool", "global_avg_pool",
                                "l2_normalize", "l2_norm_div", "images_to_unit_range",
                                "float_passthrough"])
def test_misc_ops_match_jax(op):
    r = _rng(3)
    x = r.standard_normal((2, 7, 7, 16)).astype(np.float32)
    xt = _nhwc_to_nchw(x)
    if op == "reflect_pad":
        np.testing.assert_array_equal(_nchw_to_nhwc(t_ops.reflect_pad(xt, 1)),
                                      np.asarray(j_ops.reflect_pad(jnp.asarray(x), 1)))
    elif op == "stride_pool":
        np.testing.assert_array_equal(_nchw_to_nhwc(t_ops.stride_pool(xt, 2)),
                                      np.asarray(j_ops.stride_pool(jnp.asarray(x), 2)))
    elif op == "global_avg_pool":
        np.testing.assert_allclose(t_ops.global_avg_pool(xt).numpy(),
                                   np.asarray(j_ops.global_avg_pool(jnp.asarray(x))),
                                   atol=1e-6)
    elif op in ("l2_normalize", "l2_norm_div"):
        v = r.standard_normal((4, 512)).astype(np.float32)
        if op == "l2_normalize":
            v[2] = 0.0  # eps on the norm keeps a zero row finite
        got = getattr(t_ops, op)(torch.from_numpy(v), axis=1).numpy()
        want = np.asarray(getattr(j_ops, op)(jnp.asarray(v), axis=1))
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-6)
        assert np.isfinite(got).all()
    elif op == "images_to_unit_range":
        u8 = r.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
        got = t_ops.images_to_unit_range(torch.from_numpy(u8))
        assert got.dtype == torch.float32
        # the same IEEE ops in the same order: bitwise equal
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(j_ops.images_to_unit_range(jnp.asarray(u8))))
    else:
        assert t_ops.images_to_unit_range(xt) is xt


@pytest.mark.parametrize("init", ["kaiming_normal", "kaiming_uniform", "xavier_uniform",
                                  "bias_uniform"])
def test_initializers_match_jax_distribution(init):
    """The two frameworks draw different random numbers from a seed, so the
    initializers are held to the same law: bounds and standard deviation."""
    shape, fan_in, fan_out = (256, 512), 512, 256
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    if init == "xavier_uniform":
        got = t_ops.xavier_uniform(shape, fan_in, fan_out, generator=g)
        want = j_ops.xavier_uniform(key, shape, fan_in, fan_out)
    else:
        got = getattr(t_ops, init)(shape, fan_in, generator=g)
        want = getattr(j_ops, init)(key, shape, fan_in)
    want = np.asarray(want)
    got = got.numpy()
    # 131072 draws: the sample std is well within 2% of the law's
    np.testing.assert_allclose(got.std(), want.std(), rtol=2e-2)
    if init != "kaiming_normal":
        bound = float(np.abs(want).max())
        assert np.abs(got).max() <= bound * 1.001
        assert np.abs(got).max() >= bound * 0.99


def _load_conv_layer(module, params, state):
    """JAX ConvLayer params -> the port's ConvLayer."""
    with torch.no_grad():
        module.conv2d.weight.copy_(torch.from_numpy(
            np.array(params["conv"]["w"]).transpose(3, 2, 0, 1)))
        if "b" in params["conv"]:
            module.conv2d.bias.copy_(torch.from_numpy(np.array(params["conv"]["b"])))
        if params["norm"]:
            module.norm.norm.weight.copy_(torch.from_numpy(np.array(params["norm"]["scale"])))
            module.norm.norm.bias.copy_(torch.from_numpy(np.array(params["norm"]["bias"])))
        if state["norm"]:
            module.norm.norm.running_mean.copy_(torch.from_numpy(np.array(state["norm"]["mean"])))
            module.norm.norm.running_var.copy_(torch.from_numpy(np.array(state["norm"]["var"])))
        if "slope" in params["relu"]:
            module.relu.func.weight.copy_(torch.from_numpy(np.array(params["relu"]["slope"])))


@pytest.mark.parametrize("kind", [
    "bn-prelu", "in-relu", "gn-leakyrelu", "pixel-selu", "layer-none", "none-prelu",
    "bn-prelu-down", "bn-prelu-up", "residual"])
def test_layers_match_jax(kind):
    """Eval mode (running stats) and, for the BN kinds, train mode (batch
    statistics) vs the JAX layer with training False and True; a module
    follows `module.training`, so each mode is set explicitly."""
    parts = kind.split("-")
    norm, relu = ("bn", "prelu") if kind == "residual" else parts[:2]
    scale = parts[2] if len(parts) > 2 else "none"
    cin, cout = (32, 32) if kind == "residual" else (32, 64)
    x = _rng(4).standard_normal((2, 6, 6, cin)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    kw = {"norm_type": norm, "relu_type": relu}
    for training in ((False, True) if norm == "bn" else (False,)):
        if kind == "residual":
            p, s = j_layers.init_residual_block(key, cin, cout, **kw)
            want, _ = j_layers.apply_residual_block(p, s, jnp.asarray(x), training=training,
                                                    **kw)
            mod = t_layers.ResidualBlock(cin, **kw)
            _load_conv_layer(mod.conv1, p["conv1"], s["conv1"])
            _load_conv_layer(mod.conv2, p["conv2"], s["conv2"])
        else:
            p, s = j_layers.init_conv_layer(key, cin, cout, **kw)
            want, _ = j_layers.apply_conv_layer(p, s, jnp.asarray(x), scale=scale,
                                                training=training, **kw)
            mod = t_layers.ConvLayer(cin, cout, scale=scale, **kw)
            _load_conv_layer(mod, p, s)
        mod.train(training)
        with torch.no_grad():
            got = mod(_nhwc_to_nchw(x))
        # fp32 convolutions with another summation order
        np.testing.assert_allclose(_nchw_to_nhwc(got), np.asarray(want), atol=2e-5, rtol=2e-5,
                                   err_msg=f"training={training}")


def test_import_leaves_jax_out():
    """Importing the port pulls in neither jax nor ffrnet_tpu. A subprocess,
    because this test process has imported jax already."""
    code = ("import sys, ffrnet_torch, ffrnet_torch.api, ffrnet_torch.ops.kernels, "
            "ffrnet_torch.checkpoint.convert, ffrnet_torch.ops.align, "
            "ffrnet_torch.ops.kernels.warp, ffrnet_torch.tools.align_dataset, "
            "ffrnet_torch.tools.mma_rate, ffrnet_torch.training.trainer, "
            "ffrnet_torch.training.losses, ffrnet_torch.training.optimizers, "
            "ffrnet_torch.training.adabound, ffrnet_torch.training.schedules, "
            "ffrnet_torch.data.datasets, ffrnet_torch.tools.bench_train, "
            "ffrnet_torch.tools.profile_train, ffrnet_torch.train, ffrnet_torch.run, "
            "ffrnet_torch.config, ffrnet_torch.data.pipeline, ffrnet_torch.data.native, "
            "ffrnet_torch.checkpoint.store, ffrnet_torch.training.feature_cache, "
            "ffrnet_torch.utils.logger, ffrnet_torch.utils.timer, ffrnet_torch.utils.profiling, "
            "ffrnet_torch.eval.runner, ffrnet_torch.eval.search, ffrnet_torch.eval.visualize, "
            "ffrnet_torch.serving, ffrnet_torch.serving.service, ffrnet_torch.serving.http, "
            "ffrnet_torch.tools.bench_serving, ffrnet_torch.utils.image, "
            "ffrnet_torch.examples.embed_and_verify, ffrnet_torch.examples.serve_http, "
            "ffrnet_torch.ops.quant, ffrnet_torch.models.quantize, "
            "ffrnet_torch.ops.kernels.int8_conv, ffrnet_torch.examples.int8_serving; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'ffrnet_tpu')); print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_jax_in_port_sources():
    """No import statement of jax or ffrnet_tpu in the port or chip_smoke.py
    (docstrings may name the JAX counterpart of a module)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ffrnet_tpu)\b"
                     r"|import_module\(\s*['\"](jax|ffrnet_tpu)", re.M)
    files = sorted((ROOT / "ffrnet_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f"{f} imports jax or ffrnet_tpu"
