"""The port's int8 ops (ffrnet_torch/ops/quant.py, ops/kernels/int8_conv.py)
against ffrnet_tpu/ops/quant.py on the CPU, on inputs made with numpy.

On the CPU the int8 product is the kernel's plain twin (float64, exact);
tests/test_torch_cuda.py holds the kernel against the same twin on a card.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

from ffrnet_torch.models.quantize import _bake_static_scales
from ffrnet_torch.ops import nn as ops
from ffrnet_torch.ops import quant as tq
from ffrnet_torch.ops.kernels.int8_conv import int8_conv, pack_weight, to_nhwc
from ffrnet_tpu.ops import quant as jq

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32).astype(np.int64)


def _ulps(got, want):
    """Largest distance in fp32 units in the last place (finite values of
    one sign, as here)."""
    return int(np.abs(_bits(got) - _bits(want)).max())


@pytest.mark.parametrize("shape", [(3, 3, 64, 128), (3, 3, 561, 256), (1, 1, 256, 512),
                                   (3, 3, 49, 49), "linear"])
def test_quantize_weight_matches_jax(shape):
    """q equal and scale equal to the bit. JAX's HWIO axis -1 is the port's
    OIHW (and Linear) axis 0; a zero output channel takes scale 1e-12/127."""
    rng = np.random.default_rng(0)
    if shape == "linear":
        w = (rng.standard_normal((512, 25088)) * 0.01).astype(np.float32)
        w[7] = 0.0
        want = jq.quantize_weight(jnp.asarray(w), channel_axis=0)
        q, scale = tq.quantize_weight(torch.from_numpy(w), 0)
        q_j = np.asarray(want["q"])
    else:
        w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
        w[..., 3] = 0.0
        want = jq.quantize_weight(jnp.asarray(w), channel_axis=-1)
        q, scale = tq.quantize_weight(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), 0)
        q_j = np.asarray(want["q"]).transpose(3, 2, 0, 1)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), q_j)
    np.testing.assert_array_equal(_bits(scale.numpy()), _bits(want["scale"]))
    assert scale[3 if shape != "linear" else 7] == np.float32(1e-12) / np.float32(127)
    back = tq.dequantize_weight(q, scale)
    w_t = torch.from_numpy(w if shape == "linear" else w.transpose(3, 2, 0, 1).copy())
    # round to nearest: each element within half a step of its channel
    assert ((back - w_t).abs() <= scale.reshape([-1] + [1] * (w_t.ndim - 1)) / 2 + 1e-7).all()


@pytest.mark.parametrize("case", ["random", "extreme_linear", "extreme_conv"])
def test_plain_twin_is_the_exact_integer_product(case):
    """The twin's product against an int64 numpy product: random operands
    with padding and stride, and operands at +/-127 everywhere with
    K = 25088 (the Linear) or 3x3x561, the largest accumulators, whose fp32
    rounding the epilogue then takes."""
    rng = np.random.default_rng(1)
    if case == "random":
        x = rng.integers(-127, 128, (2, 49, 9, 9)).astype(np.int8)
        w = rng.integers(-127, 128, (49, 49, 3, 3)).astype(np.int8)
        stride, pad = 2, 1
    elif case == "extreme_linear":
        x = np.full((2, 25088), 127, np.int8)
        x[1] = -127
        w = np.full((49, 25088), -127, np.int8)
        stride, pad = 1, 0
    else:
        x = np.full((1, 561, 9, 9), -127, np.int8)
        w = np.full((3, 561, 3, 3), -127, np.int8)
        stride, pad = 1, 0
    deq = np.ones(w.shape[0], np.float32)
    got = int8_conv(to_nhwc(torch.from_numpy(x)), pack_weight(torch.from_numpy(w)),
                    torch.from_numpy(deq), stride=stride, padding=pad)
    if x.ndim == 2:
        want = x.astype(np.int64) @ w.astype(np.int64).T
        want = want[:, :, None, None]
    else:
        xp = np.pad(x.astype(np.int64), ((0, 0), (0, 0), (pad, pad), (pad, pad)))
        ho = (xp.shape[2] - w.shape[2]) // stride + 1
        want = np.zeros((x.shape[0], w.shape[0], ho, ho), np.int64)
        for r in range(w.shape[2]):
            for s in range(w.shape[3]):
                win = xp[:, :, r:r + stride * ho:stride, s:s + stride * ho:stride]
                want += np.einsum("nchw,oc->nohw", win, w[:, :, r, s].astype(np.int64))
    if case != "random":
        assert np.abs(want).max() == 127 * 127 * (25088 if x.ndim == 2 else 561 * 9)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def _site(kind, cin, cout, k, bias, rng):
    """A float layer and its weights as numpy (OIHW / (out, in))."""
    layer = nn.Conv2d(cin, cout, k, bias=bias) if kind == "conv" else nn.Linear(cin, cout, bias=bias)
    w = (rng.standard_normal(tuple(layer.weight.shape)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32) if bias else None
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
        if bias:
            layer.bias.copy_(torch.from_numpy(b))
    return layer, w, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scales", ["dynamic", "static"])
@pytest.mark.parametrize("kind", ["conv3x3_s2_p1", "conv3x3_p0_c49", "conv1x1_s2", "linear"])
def test_int8_ops_match_jax(kind, scales, dtype):
    """conv2d_int8 / linear_int8 against ffrnet_tpu.ops.quant on shared
    weights and inputs. The int8 operands are equal (quantize_weight above;
    the activations round the same fp32 quotients), the integer products are
    exact on both sides, and the epilogue is the same two fp32 operations,
    except that XLA's CPU backend may contract them into an FMA: a few fp32
    ulps (bound 4; 0 measured), then the same cast to bf16."""
    rng = np.random.default_rng(2)
    dt, jdt = TDT[dtype], JDT[dtype]
    if kind == "linear":
        layer, _, b = _site("linear", 300, 40, 1, True, rng)
        x = rng.standard_normal((3, 300)).astype(np.float32)
    else:
        cin, cout, k, stride, pad = {"conv3x3_s2_p1": (32, 64, 3, 2, 1),
                                     "conv3x3_p0_c49": (49, 49, 3, 1, 0),
                                     "conv1x1_s2": (64, 128, 1, 2, 0)}[kind]
        layer, _, b = _site("conv", cin, cout, k, kind != "conv1x1_s2", rng)
        x = rng.standard_normal((2, cin, 9, 9)).astype(np.float32)
    site = tq.Int8Site(layer.to(dt))  # quantized from the weights in the model's type
    w = layer.weight.detach().float().numpy()
    if kind == "linear":
        wq = jq.quantize_weight(jnp.asarray(w, jdt), channel_axis=0)
    else:
        wq = jq.quantize_weight(jnp.asarray(w.transpose(2, 3, 1, 0), jdt), channel_axis=-1)
    if scales == "static":
        site.x_scale = torch.tensor(np.float32(0.8 * np.abs(x).max() / 127.0))  # clips the top
        wq["x_scale"] = jnp.float32(site.x_scale.item())
    x_t = torch.from_numpy(x).to(dt)
    jb = None if b is None else jnp.asarray(np.asarray(layer.bias.detach().float()), jdt)
    if kind == "linear":
        got = ops.linear(x_t, site)
        want = jq.linear_int8(jnp.asarray(x, jdt), wq, jb)
        got_np = got.float().numpy()
    else:
        got = ops.conv2d(x_t, site, stride=stride, padding=pad)
        want = jq.conv2d_int8(jnp.asarray(x.transpose(0, 2, 3, 1), jdt), wq, jb,
                              stride=stride, padding=pad)
        got_np = got.float().numpy().transpose(0, 2, 3, 1)
    assert got.dtype == dt and got_np.shape == want.shape
    want_np = np.asarray(want, np.float32)
    if dtype == "float32":
        assert _ulps(np.abs(got_np), np.abs(want_np)) <= 4
    else:  # one bf16 step where an FMA moved the fp32 value across a rounding point
        np.testing.assert_allclose(got_np, want_np, rtol=2 ** -7, atol=0)


def test_zero_activation_and_saturation():
    """An all-zero activation: scale 1e-12/127 and q = 0, so the output is
    the bias alone. A static scale clips values beyond it at +/-127."""
    q, scale = tq.quantize_activation(torch.zeros(2, 3, 4, 4))
    assert scale.item() == np.float32(1e-12) / np.float32(127) and not q.any()
    layer, _, b = _site("conv", 3, 5, 3, True, np.random.default_rng(3))
    site = tq.Int8Site(layer)
    y = ops.conv2d(torch.zeros(2, 3, 6, 6), site, padding=1)
    assert torch.equal(y, torch.from_numpy(b).reshape(1, 5, 1, 1).expand_as(y))
    x = torch.tensor([-3.0, -1.0, 0.5, 1.0, 2.0])
    q, _ = tq.quantize_activation(x, torch.tensor(1.0 / 127))
    assert q.tolist() == [-127, -127, 64, 127, 127]  # 63.5 rounds half to even


def test_site_keeps_fp32_scales_and_packs_operands():
    """A cast moves the bias but keeps the int8 weight and the fp32 scales;
    the packed weight pads Cout 49 -> 64 rows and Cin 561 -> 576 channels
    with zeros, and to_nhwc pads the activation's channels to match."""
    layer = nn.Conv2d(561, 49, 3, bias=True)
    site = tq.Int8Site(layer)
    site.x_scale = torch.tensor(0.5)
    cast = site.to(torch.bfloat16)
    assert cast.weight_scale.dtype == torch.float32 and cast.x_scale.dtype == torch.float32
    assert cast.bias.dtype == torch.bfloat16 and cast.weight_q.dtype == torch.int8
    wp = site.weight_packed
    assert tuple(wp.shape) == (64, 3, 3, 576) and not wp[49:].any() and not wp[..., 561:].any()
    assert torch.equal(wp[:49, :, :, :561], site.weight_q.permute(0, 2, 3, 1))
    x = torch.randint(-127, 128, (2, 561, 9, 9), dtype=torch.int8)
    xn = to_nhwc(x)
    assert tuple(xn.shape) == (2, 9, 9, 576) and xn.is_contiguous() and not xn[..., 561:].any()
    assert tuple(to_nhwc(torch.ones(3, 25088, dtype=torch.int8)).shape) == (3, 1, 1, 25088)
    assert set(dict(site.named_buffers())) == {"weight_q", "weight_scale", "x_scale", "bias",
                                                "weight_packed"}
    assert "weight_packed" not in site.state_dict()


@pytest.mark.parametrize("bad", ["dtype", "cp", "coutp", "deq", "bias", "out_dtype", "window"])
def test_int8_conv_rejects_what_the_kernel_does_not_take(bad):
    xq = torch.zeros(1, 9, 9, 64, dtype=torch.int8)
    wp = torch.zeros(64, 3, 3, 64, dtype=torch.int8)
    deq, bias, kw = torch.ones(49), torch.zeros(49), {}
    if bad == "dtype":
        xq = xq.float()
    elif bad == "cp":
        xq, wp = xq[..., :49], wp[..., :49]
    elif bad == "coutp":
        wp = wp[:49]
    elif bad == "deq":
        deq = torch.ones(65)
    elif bad == "bias":
        bias = bias.double()
    elif bad == "out_dtype":
        kw = {"out_dtype": torch.float16}
    else:
        xq = xq[:, :2, :2]
    with pytest.raises((TypeError, ValueError)):
        int8_conv(xq, wp, deq, bias, **kw)


def test_calibrated_site_matches_jax():
    """One site calibrated on two batches by both packages: the recorded
    amaxes are the inputs' own, so x_scale is equal to the bit; the
    calibration pass runs the float op on the dequantized weight, and the
    baked site then runs int8 like JAX's."""
    rng = np.random.default_rng(4)
    layer, w, b = _site("conv", 16, 32, 3, True, rng)
    batches = [rng.standard_normal((2, 16, 8, 8)).astype(np.float32) * s for s in (1.0, 3.0)]
    site = tq.Int8Site(layer)
    outs = []
    _bake_static_scales([site], lambda x: outs.append(ops.conv2d(x, site, padding=1)),
                        [torch.from_numpy(x) for x in batches], margin=1.3)

    from ffrnet_tpu.models.quantize import _bake_static_scales as j_bake

    wq = jq.quantize_weight(jnp.asarray(w.transpose(2, 3, 1, 0)))
    j_outs = []
    j_bake([wq], lambda x: j_outs.append(jq.conv2d_int8(x, wq, jnp.asarray(b), padding=1)),
           [jnp.asarray(x.transpose(0, 2, 3, 1)) for x in batches], margin=1.3)
    assert _bits(site.x_scale.numpy()) == _bits(wq["x_scale"])
    # the calibration pass's float conv on the dequantized weight (fp32
    # sums in another order: XLA's and oneDNN's)
    for o, jo in zip(outs, j_outs):
        np.testing.assert_allclose(o.numpy().transpose(0, 2, 3, 1), np.asarray(jo),
                                   atol=1e-5, rtol=1e-5)
    x = rng.standard_normal((2, 16, 8, 8)).astype(np.float32) * 4.0  # beyond the range: clips
    got = ops.conv2d(torch.from_numpy(x), site, padding=1).numpy().transpose(0, 2, 3, 1)
    want = np.asarray(jq.conv2d_int8(jnp.asarray(x.transpose(0, 2, 3, 1)), wq, jnp.asarray(b),
                                     padding=1))
    assert _ulps(np.abs(got), np.abs(want)) <= 4


class _Twice(nn.Module):
    def __init__(self, site):
        super().__init__()
        self.site = site

    def forward(self, x):
        return ops.linear(ops.linear(x, self.site), self.site)


def test_bake_static_scales_errors():
    """ffrnet_tpu/models/quantize.py:152-193's errors: margin <= 0, an
    already baked site, no sites, no batches, and a site that did not run
    exactly once per batch."""
    site = tq.Int8Site(nn.Linear(8, 8))
    x = [torch.randn(2, 8)]
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="margin"):
            _bake_static_scales([site], lambda _: None, x, margin=bad)
    with pytest.raises(ValueError, match="no quantized sites"):
        _bake_static_scales([], lambda _: None, x, margin=1.0)
    with pytest.raises(ValueError, match="at least one batch"):
        _bake_static_scales([site], lambda _: None, [], margin=1.0)
    with pytest.raises(AssertionError, match="exactly once"):
        _bake_static_scales([site], _Twice(site), x, margin=1.0)
    assert site.calibration is None and site.x_scale is None  # disarmed after each
    _bake_static_scales([site], lambda t: ops.linear(t, site), x, margin=2.0)
    assert site.x_scale.item() == np.float32(float(x[0].abs().max()) * 2.0 / 127.0)
    with pytest.raises(ValueError, match="already has baked"):
        _bake_static_scales([site], lambda t: ops.linear(t, site), x, margin=1.0)
