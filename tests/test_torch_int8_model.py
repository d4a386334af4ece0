"""The port's int8 models (ffrnet_torch/models/quantize.py, FFRNet.prepare(
quantize_int8=...) / calibrate_int8, train.prepare_int8_encoder) against
ffrnet_tpu on the CPU, on the same weights and numpy-made faces.

Each package runs its int8 products exactly (the port's twin in float64,
XLA in int32), but the float layers between the int8 sites sum in other
orders (oneDNN against XLA), and an ulp upstream can move an activation
across an int8 rounding point, one level, which then spreads: the whole
model is held to JAX by cosine, the bound stated where it is checked.
"""

import numpy as np
import pytest
import torch

from ffrnet_torch.api import FFRNet
from ffrnet_torch.models import irse as t_irse
from ffrnet_torch.models.quantize import (jax_leaf_path, quantize_encoder, quantize_recnet,
                                          quantized_sites)
from ffrnet_torch.ops.quant import has_int8_sites
from ffrnet_tpu.api import FFRNet as JFFRNet
from ffrnet_tpu.checkpoint.torch_convert import backbone_from_torch, recnet_from_torch
from ffrnet_tpu.models.quantize import quantized_leaf_items

torch.set_num_threads(1)


def _faces(seed, n=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 112, 112, 3)).astype(np.float32)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


@pytest.fixture(scope="module")
def pair():
    """(JAX float, JAX int8 'all' calibrated, port float, port int8 'all'
    calibrated), all on the port's random weights of seed 0 (the JAX trees
    through ffrnet_tpu's own torch_convert), calibrated on the same two
    faces."""
    tf = FFRNet.random(0, device="cpu")
    sd = {k: v.numpy() for k, v in tf.encoder.state_dict().items()}
    rsd = {k: v.numpy() for k, v in tf.recnet.state_dict().items()}
    jf = JFFRNet(*backbone_from_torch(sd), *recnet_from_torch(rsd)).prepare()
    cal = _faces(10)
    jq = jf.prepare(quantize_int8="all").calibrate_int8([cal])
    tq = tf.prepare(quantize_int8="all").calibrate_int8([cal])
    return jf, jq, tf, tq


def test_sites_pair_one_to_one_with_jax(pair):
    """52 encoder sites (48 body convs, 3 shortcuts, the Linear) and 15
    RecNet sites, each with the JAX leaf of the same path: equal int8
    weights (OIHW against HWIO), scales equal to the bit."""
    _, jq, _, tq = pair
    for model, tree, n in ((tq.encoder, jq.enc_params, 52), (tq.recnet, jq.rec_params, 15)):
        sites = {jax_leaf_path(p): s for p, s in quantized_sites(model)}
        leaves = dict(quantized_leaf_items(tree))
        assert len(sites) == len(leaves) == n and set(sites) == set(leaves)
        for path, site in sites.items():
            q = np.asarray(leaves[path]["q"])
            q = q if q.ndim == 2 else q.transpose(3, 2, 0, 1)
            np.testing.assert_array_equal(site.weight_q.numpy(), q, err_msg=path)
            np.testing.assert_array_equal(site.weight_scale.numpy(),
                                          np.asarray(leaves[path]["scale"]), err_msg=path)
    assert sum(p.startswith("body.") and p.endswith("shortcut_layer.0")
               for p, _ in quantized_sites(tq.encoder)) == 3


def test_calibrated_scales_match_jax(pair):
    """Each site's x_scale against JAX's: the amax of the site's input in the
    calibration pass, after float layers that sum in another order (the
    first site's input is the stem's output): within 1e-5 relative."""
    _, jq, _, tq = pair
    for model, tree in ((tq.encoder, jq.enc_params), (tq.recnet, jq.rec_params)):
        leaves = dict(quantized_leaf_items(tree))
        for path, site in quantized_sites(model):
            want = float(leaves[jax_leaf_path(path)]["x_scale"])
            assert site.x_scale.dtype == torch.float32
            assert site.x_scale.item() == pytest.approx(want, rel=1e-5), path


def test_int8_model_tracks_jax_and_float(pair):
    """Held-out faces: the port's calibrated int8 model against JAX's, and
    against its own float model (>= 0.99, the JAX package's bound,
    tests/test_quant.py). Against JAX: both products are exact, but a BN,
    PReLU or SE output an ulp apart (oneDNN and XLA order their sums
    otherwise) moves an activation across a rounding point now and then;
    the level it moves spreads through every later site, and the x_scales
    themselves are up to 1e-5 apart. Measured raw 0.99961, rectified
    0.99995 (int8 vs float: 0.99951, 0.99987): bound 0.999."""
    jf, jq, tf, tq = pair
    x = _faces(11)
    want = [np.asarray(t, np.float32) for t in jq.embed(x)]
    got = [t.numpy() for t in tq.embed(x)]
    flt = [t.numpy() for t in tf.embed(x)]
    for g, w, f in zip(got, want, flt):
        assert (_cos(g, w) >= 0.999).all(), _cos(g, w)
        assert (_cos(g, f) >= 0.99).all(), _cos(g, f)


def test_dynamic_static_and_batch_independence(pair):
    """Dynamic int8 tracks float (>= 0.99), static tracks dynamic on its
    own calibration batch (>= 0.999, tests/test_quant.py:128), a static
    model embeds a face the same alone as in a batch (bit-equal on the
    CPU), and a dynamic one does not: the batch amax moves its scales."""
    _, _, tf, tq = pair
    cal, x = _faces(10), _faces(12)
    dyn = tf.prepare(quantize_int8="all")
    for a, b in zip(dyn.embed(x), tf.embed(x)):
        assert (_cos(a, b) >= 0.99).all()
    for a, b in zip(tq.embed(cal), dyn.embed(cal)):
        assert (_cos(a, b) >= 0.999).all()
    loud = np.concatenate([x[:1], 3.0 * x[1:]])
    for model, equal in ((tq, True), (dyn, False)):
        alone = model.embed(x[:1])[0]
        batched = model.embed(loud)[0][:1]
        assert torch.equal(alone, batched) == equal


def test_prepare_modes_and_errors(pair):
    """prepare(quantize_int8=...) as ffrnet_tpu/api.py:69-118 and
    tests/test_quant.py:288-362: True == 'encoder', 'recnet', 'all', a bad
    mode, fold_bn on an int8 encoder, calibrate without int8 sites, a
    margin <= 0 and a second calibration raise; the float model is left as
    it was; quantize is idempotent."""
    _, _, tf, tq = pair
    for mode, enc, rec in ((True, True, False), ("encoder", True, False),
                           ("recnet", False, True), ("all", True, True), (False, False, False)):
        m = tf.prepare(quantize_int8=mode)
        assert (has_int8_sites(m.encoder), has_int8_sites(m.recnet)) == (enc, rec)
    assert not has_int8_sites(tf.encoder) and not has_int8_sites(tf.recnet)
    with pytest.raises(ValueError, match="quantize_int8"):
        tf.prepare(quantize_int8="both")
    with pytest.raises(ValueError, match="fold_bn"):
        tq.prepare(fold_bn=True)
    with pytest.raises(ValueError, match="prepare\\(quantize_int8"):
        tf.calibrate_int8([_faces(1)])
    with pytest.raises(ValueError, match="margin"):
        tf.prepare(quantize_int8=True).calibrate_int8([_faces(1)], margin=0.0)
    with pytest.raises(ValueError, match="already has baked"):
        tq.calibrate_int8([_faces(1)])
    enc = tq.encoder
    again = quantize_encoder(enc)
    assert len(quantized_sites(again)) == 52
    assert torch.equal(again.body[0].res_layer[1].weight_q, enc.body[0].res_layer[1].weight_q)
    assert len(quantized_sites(quantize_recnet(tq.recnet))) == 15
    # the stem, SE and Conv4Channel stay float
    assert type(enc.input_layer[0]) is torch.nn.Conv2d
    assert type(enc.body[0].res_layer[5].fc1) is torch.nn.Conv2d
    assert type(tq.recnet.Conv4Channel[0]) is torch.nn.Linear


def test_calibrate_uint8_and_recnet_only(pair):
    """uint8 calibration batches are normalized first (the JAX package's
    round-5 fix), so they bake the scales of the same faces in [-1, 1];
    a RecNet-only int8 model calibrates on the float encoder's maps: its
    raw embeddings are the float model's, bit for bit, its rectified ones
    track at >= 0.99."""
    _, _, tf, _ = pair
    u8 = np.random.default_rng(13).integers(0, 256, (2, 112, 112, 3), dtype=np.uint8)
    unit = (u8.astype(np.float32) / 255.0 - 0.5) / 0.5
    enc_q = tf.prepare(quantize_int8=True)
    a, b = enc_q.calibrate_int8([u8]), enc_q.calibrate_int8([unit])
    for (_, sa), (_, sb) in zip(quantized_sites(a.encoder), quantized_sites(b.encoder)):
        assert torch.equal(sa.x_scale, sb.x_scale)
    rec_q = tf.prepare(quantize_int8="recnet").calibrate_int8([_faces(14)])
    x = _faces(15)
    (raw_f, rect_f), (raw_q, rect_q) = tf.embed(x), rec_q.embed(x)
    assert torch.equal(raw_f, raw_q)
    assert (_cos(rect_q, rect_f) >= 0.99).all()


def test_prepare_int8_encoder_for_the_driver(tmp_path):
    """train.prepare_int8_encoder (ffrnet_tpu/train.py:121-175): BN folded,
    cast to the compute type, 52 int8 sites with static scales from the
    first 8 images of both streams (rng 0, uint8 samples mapped to [-1, 1]
    as x / 127.5 - 1); its embeddings track the float encoder's."""
    from ffrnet_torch.data.datasets import SyntheticPairs
    from ffrnet_torch.models.quantize import calibrate_activation_scales
    from ffrnet_torch.models.optimize import fold_backbone_bn
    from ffrnet_torch.train import prepare_int8_encoder

    enc = t_irse.build_backbone(generator=torch.Generator().manual_seed(0))
    ds = SyntheticPairs(num_identities=4, host_normalize=False)
    q = prepare_int8_encoder(enc, ds, "fp32")
    sites = quantized_sites(q)
    assert len(sites) == 52 and all(s.x_scale is not None for _, s in sites)
    assert not q.training and q.body[0].res_layer[3].bias is not None  # folded
    rng, imgs = np.random.default_rng(0), []
    for i in range(4):
        item = ds.get(i, rng)
        imgs += [item["img_non"].astype(np.float32) / 127.5 - 1.0,
                 item["img_ocl"].astype(np.float32) / 127.5 - 1.0]
    x = torch.from_numpy(np.stack(imgs)).permute(0, 3, 1, 2).contiguous()
    want = calibrate_activation_scales(quantize_encoder(fold_backbone_bn(enc)), [x])
    for (_, a), (_, b) in zip(sites, quantized_sites(want)):
        assert torch.equal(a.x_scale, b.x_scale)
    with torch.no_grad():
        got, ref = q(x[:2])[1], enc(x[:2])[1]
    assert (_cos(got, ref) >= 0.99).all()
    half = prepare_int8_encoder(enc, ds, "bf16")
    assert half.input_layer[0].weight.dtype == torch.bfloat16
    assert half.body[0].res_layer[1].weight_scale.dtype == torch.float32
