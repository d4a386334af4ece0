"""The benchmark's copies of the program's arithmetic that its metrics
use equal the originals today, and the int8 site list equals the calls a
real int8 encoder makes."""

import math

import numpy as np
import pytest
import torch

from benchmarks import bounds, flops


def test_stage_flops_equal_bench_stages():
    from ffrnet_torch.tools.bench_stages import stage_flops

    for n in (1, 64, 256):
        assert flops.stage_flops(n) == stage_flops(n)


def test_bounds_equal_chip_smoke():
    import chip_smoke

    for n, itemsize in ((256, 2), (128, 4), (1, 2)):
        nbytes, ops = n * itemsize * 1e6, n * 1e9
        assert bounds.roof(nbytes, ops) == chip_smoke.roof(nbytes, ops)
        assert bounds.se_bound(n, itemsize) == chip_smoke.se_bound(n, itemsize)
        assert bounds.cb_bound(n, itemsize) == chip_smoke.cb_bound(n, itemsize)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_site_calls_are_the_encoders(monkeypatch, dtype):
    """int8_site_calls(n) lists the shapes of the 52 int8_conv calls of a
    BN-folded int8 encoder, and int8_bound over them equals chip_smoke's
    over the calls as made."""
    import chip_smoke
    import ffrnet_torch.ops.quant as quant
    from ffrnet_torch.api import FFRNet

    made = []

    def record(xq, wp, deq, bias=None, *, stride=1, padding=0, out_dtype=torch.float32):
        made.append((xq, wp, deq, bias, stride, padding, out_dtype))
        h = (xq.shape[1] + 2 * padding - wp.shape[1]) // stride + 1
        w = (xq.shape[2] + 2 * padding - wp.shape[2]) // stride + 1
        return torch.zeros((xq.shape[0], deq.shape[0], h, w), dtype=out_dtype)

    monkeypatch.setattr(quant, "int8_conv", record)
    model = FFRNet.random(0, device="cpu").prepare(fold_bn=True, dtype=dtype,
                                                   quantize_int8="encoder")
    with torch.no_grad():
        model.embed(np.zeros((2, 112, 112, 3), np.uint8))
    itemsize = torch.empty((), dtype=dtype).element_size()
    want = [(tuple(x.shape), tuple(w.shape), d.shape[0], b is not None, s, p, itemsize)
            for x, w, d, b, s, p, _ in made]
    assert bounds.int8_site_calls(2, itemsize) == want
    assert bounds.int8_bound(want) == chip_smoke.int8_bound(made)


def test_warp_footprint():
    eye = torch.tensor([[[1.0, 0.0, 10.0], [0.0, 1.0, 20.0]]], dtype=torch.float64)
    assert bounds.warp_footprint_pixels(eye, (250, 250)) == 112 * 112
    half = eye.clone()
    half[0, :, 2] += 0.5
    assert bounds.warp_footprint_pixels(half, (250, 250)) == 113 * 113
    edge = eye.clone()
    edge[0, 0, 2] = 200.0  # the crop runs 62 columns off the canvas
    assert bounds.warp_footprint_pixels(edge, (250, 250)) == 50 * 112


def test_model_flops():
    per_face = flops.embed_flops(1)
    assert flops.embed_flops(256) == 256 * per_face
    assert math.isclose(flops.encoder_flops(1) / 1e9, 12.593, rel_tol=1e-3)
    head = 2 * 64 * 512 * 10575
    assert flops.train_step_flops(64) == (flops.encoder_flops(128)
                                          + 6 * (flops.recnet_flops(64) + head))
