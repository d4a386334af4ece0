"""The plain reference agrees with the port's plain CPU path at a tiny
batch, holds the weights the program is handed, drawn with the port's
init distributions, and imports nothing of the program, of JAX or of the
JAX package."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmarks import harness, system
from benchmarks.reference import align, irse, recnet
from benchmarks.reference.numerics import Numerics
from benchmarks.reference.serve import Reference, unit_range

CONFIG = json.loads((harness.HERE / "configs" / "irse50-recnet-fused.json").read_text())
INT8 = json.loads((harness.HERE / "configs" / "irse50-recnet-int8.json").read_text())


def _cos_gap(a, b):
    a, b = a.double(), b.double()
    return float((1 - (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))).max())


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmarks.reference.irse, benchmarks.reference.recnet, "
            "benchmarks.reference.align, benchmarks.reference.train, "
            "benchmarks.reference.serve, benchmarks.reference.numerics\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, check=True,
                         capture_output=True, text=True).stdout
    tops = set(json.loads(out.replace("'", '"')))
    assert not tops & {"ffrnet_torch", "jax", "jaxlib", "flax", "ffrnet_tpu"}


def test_program_holds_the_benchmarks_weights():
    from ffrnet_torch.models.recnet import build_recnet

    cpu = torch.device("cpu")
    enc = system.encoder(CONFIG, 5, cpu).state_dict()
    ref = irse.init_params(5)
    assert set(ref) == {k for k in enc if not k.endswith("num_batches_tracked")}
    assert all(torch.equal(ref[k], enc[k]) for k in ref)
    assert all(int(v) == 0 for k, v in enc.items() if k.endswith("num_batches_tracked"))
    rec = system.loaded(build_recnet(system.recnet_config(CONFIG)),
                        system.recnet_weights(CONFIG, 5, cpu)).state_dict()
    ref = recnet.init_params(6)
    assert set(ref) == {k for k in rec if not k.endswith("num_batches_tracked")}
    assert all(torch.equal(ref[k], rec[k]) for k in ref)


@pytest.mark.parametrize("net", ["irse", "recnet"])
def test_weights_follow_the_ports_init(net):
    """Each conv, Linear and classifier leaf has the distribution the port's
    own init gives it: the same constants, and the same mean and spread
    within sampling error. Each BN and PReLU leaf is drawn per channel in
    its range instead (the reference's docstrings), none of them constant."""
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.models.recnet import RecNetConfig, build_recnet

    g = torch.Generator().manual_seed(9)
    if net == "irse":
        module, ours = build_backbone(generator=g), irse.init_params(9)
    else:
        module, ours = build_recnet(RecNetConfig(), generator=g), recnet.init_params(9)
    port, owner = module.state_dict(), dict(module.named_modules())
    bn_ranges = {"weight": (0.5, 1.5), "bias": (-0.05, 0.05), "running_mean": (-0.05, 0.05),
                 "running_var": (0.5, 1.5)}
    for k, v in ours.items():
        p = port[k]
        parent, leaf = k.rsplit(".", 1)
        if isinstance(owner[parent], torch.nn.PReLU):
            assert 0.05 <= float(v.min()) and float(v.max()) <= 0.45 and v.std() > 0.05, k
            continue
        if isinstance(owner[parent], torch.nn.modules.batchnorm._BatchNorm):
            lo, hi = bn_ranges[leaf]
            assert lo <= float(v.min()) and float(v.max()) <= hi and v.std() > 0, k
            continue
        if bool((p == p.flatten()[0]).all()):
            assert torch.equal(v, p), k
            continue
        tol = 6.0 / p.numel() ** 0.5
        assert abs(float(v.std()) / float(p.std()) - 1) < tol + 0.01, k
        assert abs(float(v.mean() - p.mean())) < tol * float(p.std()), k


def test_embeddings_agree_with_the_port_fp32():
    faces = np.random.default_rng(0).integers(0, 256, (2, 112, 112, 3), dtype=np.uint8)
    model = system.serving_model(CONFIG, "fp32", 3, torch.device("cpu"))
    raw, rect = model.embed(faces)
    want_raw, want_rect = Reference(CONFIG, 3, torch.device("cpu")).embed(
        unit_range(torch.from_numpy(faces)))
    assert _cos_gap(raw, want_raw) < 1e-6 and _cos_gap(rect, want_rect) < 1e-6


def test_fold_bn_agrees_with_the_port():
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.models.optimize import fold_backbone_bn

    model = build_backbone(generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm1d)):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
    p = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    x = torch.rand((2, 3, 112, 112), generator=g) * 2 - 1
    folded = fold_backbone_bn(model)
    with torch.no_grad():
        fm, emb = folded(x)
        want_fm, want_emb = irse.forward(irse.fold_bn(p), x, Numerics())
        plain_fm, _ = irse.forward(p, x, Numerics())
    assert torch.allclose(fm, want_fm, atol=1e-4, rtol=1e-4)
    assert torch.allclose(want_fm, plain_fm, atol=1e-4, rtol=1e-4)
    assert _cos_gap(emb, want_emb) < 1e-6


def test_alignment_agrees_with_the_port():
    from ffrnet_torch.api import REF_PTS_112
    from ffrnet_torch.ops.align import cv2_transform, warp_affine

    rng = np.random.default_rng(4)
    lmk = (align.ARCFACE_REF_PTS[None] * 2.0 + rng.normal(0, 2, (4, 5, 2)) + 20).astype(
        np.float32)
    assert np.array_equal(align.REF_PTS_112, REF_PTS_112)
    mats = align.cv2_matrices(lmk)
    port = cv2_transform(torch.from_numpy(lmk),
                         torch.from_numpy(np.broadcast_to(REF_PTS_112, lmk.shape).copy()))
    assert np.allclose(mats, port.numpy(), atol=1e-4, rtol=1e-5)
    canvas = torch.from_numpy(rng.integers(0, 256, (4, 250, 250, 3), dtype=np.uint8))
    crops = align.warp(canvas, align.inverse(mats))
    port_crops = warp_affine(canvas, port, out_hw=(112, 112))
    assert float((crops - port_crops.double()).abs().max()) < 0.05


def test_int8_reference_agrees_with_the_port():
    rng = np.random.default_rng(8)
    cal = rng.integers(0, 256, (2, 112, 112, 3), dtype=np.uint8)
    faces = rng.integers(0, 256, (2, 112, 112, 3), dtype=np.uint8)
    model = system.serving_model(INT8, "fp32", 7, torch.device("cpu"), cal)
    raw, rect = model.embed(faces)
    ref = Reference(INT8, 7, torch.device("cpu"), cal_faces=cal, dtype="fp32")
    want_raw, want_rect = ref.embed(unit_range(torch.from_numpy(faces)))
    # a product summed in another order moves some activations across a
    # rounding boundary of the int8 grid at the next site: 3e-4 here, the
    # reference against itself with exact products reads the same
    assert _cos_gap(raw, want_raw) < 2e-3 and _cos_gap(rect, want_rect) < 2e-3
    int4 = Reference(INT8, 7, torch.device("cpu"), "int4", cal_faces=cal, dtype="fp32")
    assert _cos_gap(int4.embed(unit_range(torch.from_numpy(faces)))[0], want_raw) > 1e-2


@pytest.mark.parametrize("bits", [8])
def test_numerics_quantize_symmetric(bits):
    num = Numerics(bits=bits)
    x = torch.linspace(-3, 3, 101)
    y = num._act("s", x)
    assert float(y.abs().max()) == pytest.approx(3.0) and len(torch.unique(y)) <= 2 * 127 + 1
