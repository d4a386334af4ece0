"""The channel-padded stem (ffrnet_torch/models/optimize.py::
pad_stem_input_channels) and bench_stages' stem duel against ffrnet_tpu on
the CPU, fp32, on numpy-made inputs.

The JAX contract is bit-equal embeddings, padded against unpadded
(tests/test_stem_pad.py): zero channels add exactly 0 to each product.
PyTorch keeps it on the CPU: oneDNN sums the 27 and the 72 products of the
two convolutions in an order that gives the same floats (measured: 0.0
difference on raw and folded encoders, one thread). The card is another
matter (cuDNN may pick other algorithms for C=3 and C=8): chip_smoke.py
phase 18 holds the two there to a stated bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.models.optimize import fold_backbone_bn, pad_stem_input_channels
from ffrnet_torch.tools import bench_stages
from ffrnet_tpu.checkpoint.torch_convert import backbone_from_torch
from ffrnet_tpu.models import irse as jirse
from ffrnet_tpu.models import optimize as joptimize
from ffrnet_tpu.ops import nn as jops

torch.set_num_threads(1)

TOL = 1e-5  # the port against JAX, fp32 (oneDNN and XLA sum in other orders)
# the JAX duel's arms and keys (ffrnet_tpu/tools/bench_stages.py:208-218)
DUEL_ARMS = {"prod", "im2col", "padc"}


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _faces(seed, n=2):
    return np.random.default_rng(seed).standard_normal((n, 112, 112, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def encoders():
    """{"raw": the port's seed-0 encoder, "folded": its BN fold}."""
    enc = build_backbone(generator=torch.Generator().manual_seed(0))
    return {"raw": enc, "folded": fold_backbone_bn(enc)}


@pytest.mark.parametrize("kind", ["raw", "folded"])
def test_pad_shape_idempotence_and_copy(encoders, kind):
    enc = encoders[kind]
    w0 = enc.input_layer[0].weight.detach().clone()
    padded = pad_stem_input_channels(enc)
    conv = padded.input_layer[0]
    assert conv.weight.shape == (64, 8, 3, 3) and conv.in_channels == 8
    assert torch.equal(conv.weight[:, :3], w0) and not conv.weight[:, 3:].any()
    assert (conv.bias is None) == (kind == "raw")
    if kind == "folded":
        assert torch.equal(conv.bias, enc.input_layer[0].bias)
    # the caller's model is untouched, and the copy shares no tensor with it
    stem = enc.input_layer[0]
    assert stem.weight.shape == (64, 3, 3, 3) and stem.in_channels == 3
    assert torch.equal(stem.weight, w0)
    body_w = padded.body[0].res_layer[1].weight
    assert body_w.data_ptr() != enc.body[0].res_layer[1].weight.data_ptr()
    # idempotent, and a stem already as wide as `to` is left as it is
    again = pad_stem_input_channels(padded)
    assert torch.equal(again.input_layer[0].weight, conv.weight)
    assert pad_stem_input_channels(enc, to=3).input_layer[0].weight.shape == (64, 3, 3, 3)
    assert pad_stem_input_channels(enc, to=16).input_layer[0].weight.shape == (64, 16, 3, 3)


@pytest.mark.parametrize("kind", ["raw", "folded"])
def test_padded_embeddings_bit_equal_and_match_jax(encoders, kind):
    """Padded against unpadded: bit-equal feature maps and embeddings on
    the CPU. The port's padded encoder against JAX's pad_stem_input_channels
    + irse.apply on the same weights: 1e-5 abs + rel."""
    enc = encoders[kind]
    padded = pad_stem_input_channels(enc)
    x = _faces(1)
    with torch.no_grad():
        ref = enc(_nchw(x))
        got = padded(_nchw(x))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    params, state = backbone_from_torch({k: v.numpy() for k, v in enc.state_dict().items()})
    jp = joptimize.pad_stem_input_channels(params)
    assert jp["input"]["conv"]["w"].shape == (3, 3, 8, 64)
    fm_j, emb_j, _ = jax.jit(lambda p, x: jirse.apply(p, state, x, training=False))(
        jp, jnp.asarray(x))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(emb_j), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), np.asarray(fm_j), atol=TOL,
                               rtol=TOL)


def test_padded_stem_refuses_other_channel_counts(encoders):
    padded = pad_stem_input_channels(encoders["raw"])
    x = _nchw(_faces(2, n=1))
    with torch.no_grad():
        for c in (1, 4):
            with pytest.raises(ValueError, match="3-channel"):
                padded(x[:, :1].expand(1, c, 112, 112).contiguous())


def test_im2col_patches_match_jax():
    """stem_patches (F.unfold) against lax.conv_general_dilated_patches, the
    JAX duel's patches (:192-195): the same numbers in the same order, the
    channel first, so JAX's w_flat and the OIHW weight's rows agree."""
    x = np.random.default_rng(4).standard_normal((2, 9, 7, 3)).astype(np.float32)
    want = lax.conv_general_dilated_patches(
        jnp.asarray(x), filter_shape=(3, 3), window_strides=(1, 1), padding=((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = bench_stages.stem_patches(_nchw(x))
    assert got.shape == (2, 27, 63)
    want = np.asarray(want).reshape(2, 63, 27).transpose(0, 2, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    w = np.random.default_rng(5).standard_normal((3, 3, 3, 64)).astype(np.float32)  # HWIO
    w_flat = np.transpose(w, (2, 0, 1, 3)).reshape(27, 64)
    np.testing.assert_array_equal(torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
                                  .reshape(64, -1).t().numpy(), w_flat)


@pytest.mark.parametrize("kind", ["raw", "folded"])
def test_stem_duel_keys_and_errors(encoders, kind):
    """The duel's arms and keys are the JAX tool's; on the CPU in fp32 each
    arm is within 1e-5 of prod (im2col sums 27 products in another order;
    padc adds zeros), and each arm is within 1e-5 of JAX's production
    conv on the same weights."""
    conv = encoders[kind].input_layer[0]
    x = _faces(3)
    duel = bench_stages.stem_duel(conv, _nchw(x), 1)
    assert set(duel) == DUEL_ARMS
    for arm, entry in duel.items():
        assert set(entry) == {"ms", "max_abs_err"}, arm
        assert entry["ms"] > 0 and 0.0 <= entry["max_abs_err"] <= TOL, (arm, entry)
    w = jnp.asarray(conv.weight.detach().permute(2, 3, 1, 0).numpy())
    b = None if conv.bias is None else jnp.asarray(conv.bias.detach().numpy())
    want = np.asarray(jax.jit(lambda x: jops.conv2d(x, w, b, stride=1, padding=1))(
        jnp.asarray(x)))
    fns = bench_stages.stem_duel_fns(conv)
    for arm in DUEL_ARMS:
        with torch.no_grad():
            got = fns[arm](_nchw(x)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=arm)
