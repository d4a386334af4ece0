"""ffrnet_torch.utils.image, ffrnet_torch.eval.visualize and the driver's
--visualize 1 (train.log_attention_visual) against ffrnet_tpu on the CPU."""

import os

import numpy as np
import pytest
import torch

import jax

from ffrnet_torch import train as t_train
from ffrnet_torch.checkpoint.convert import backbone_state_dict, recnet_state_dict
from ffrnet_torch.config import Options as TorchOptions
from ffrnet_torch.eval import visualize as t_vis
from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.models.recnet import RecNetConfig, build_recnet
from ffrnet_torch.utils import image as t_image
from ffrnet_tpu import train as j_train
from ffrnet_tpu.config import Options as JaxOptions
from ffrnet_tpu.eval import visualize as j_vis
from ffrnet_tpu.models import irse as j_irse
from ffrnet_tpu.models import recnet as j_recnet
from ffrnet_tpu.utils import image as j_image

torch.set_num_threads(1)


def _image_cases():
    rng = np.random.default_rng(0)
    maps = rng.standard_normal((4, 9, 9))
    maps[1] = 3.0  # a constant map: its range is taken as 1
    arr = rng.uniform(-20, 300, (3, 1, 7, 7))
    fm = rng.standard_normal((2, 7, 7, 5)).astype(np.float32)
    y, x = rng.integers(-1, 9, (2, 5)), rng.integers(-1, 9, (2, 5))
    rows = [[rng.uniform(0, 255, (4, 5, 3)) for _ in range(3)] for _ in range(2)]
    return {
        "normalization": ("normalization", (maps,), {}),
        "to_image": ("batch_numpy_to_image", (arr,), {}),
        "to_image_resized": ("batch_numpy_to_image", (arr,), {"size": (112, 96)}),
        "to_image_int_size": ("batch_numpy_to_image", (arr[:, :1],), {"size": 13,
                                                                      "v_range": (-1, 1)}),
        "select_yx": ("select_yx", (fm, y, x), {}),
        "grid": ("to_uint8_grid", (rows,), {}),
    }


@pytest.mark.parametrize("case", list(_image_cases()))
def test_image_helpers_equal_jax(case):
    name, args, kw = _image_cases()[case]
    got = getattr(t_image, name)(*args, **kw)
    want = getattr(j_image, name)(*args, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_img_to_array_equals_jax(tmp_path):
    from PIL import Image

    arr = np.random.default_rng(4).integers(0, 255, (20, 30, 3), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    Image.fromarray(arr).save(p)
    for kw in ({"mode": "bgr"}, {"size": (16, 8)}):
        np.testing.assert_array_equal(t_image.img_to_array(p, **kw), j_image.img_to_array(p, **kw))


def test_panels_equal_jax():
    rng = np.random.default_rng(2)
    n = 3
    imgs = rng.uniform(-1, 1, (2, n, 112, 112, 3)).astype(np.float32)
    m_space = rng.uniform(0, 1, (2, n, 49, 49)).astype(np.float32)
    m_channel = rng.uniform(0, 1, (2, n, 512, 512)).astype(np.float32)
    fm = rng.standard_normal((2, n, 7, 7, 512)).astype(np.float32)
    for mod in (t_vis, j_vis):
        assert mod._IMAGENET_BGR_MEAN == (131.0912, 103.8827, 91.4953)
    got = t_vis.attention_panel(imgs[0], m_space[0], m_channel[0], fm[0], n_rows=2)
    want = j_vis.attention_panel(imgs[0], m_space[0], m_channel[0], fm[0], n_rows=2)
    assert got.shape == (2 * 112, 4 * 112, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)

    class Out:
        def __init__(self, i):
            self.m_space, self.m_channel = m_space[i], m_channel[i]

    got = t_vis.visualize_pair(imgs[0], Out(0), imgs[1], Out(1), fm[0], fm[1])
    want = j_vis.visualize_pair(imgs[0], Out(0), imgs[1], Out(1), fm[0], fm[1])
    assert got.shape == (3 * 112, 8 * 112, 3)
    np.testing.assert_array_equal(got, want)


class Recorder:
    def __init__(self):
        self.images = {}

    def record_single_image(self, img, tag):
        self.images[tag] = img


def _options(cls, lfw_tree, root, **kw):
    return cls(test_data=str(lfw_tree[0]), test_pair_list=str(lfw_tree[1]), batch_size=8,
               n_thread=2, seed=0, weight_root=str(root), **kw).finalize()


def test_attention_panel_of_the_driver_matches_jax(lfw_tree, tmp_path):
    """log_attention_visual of both packages on the same weights and the
    same ocl-1 eval batch (8 pairs): the panels agree, and both write their
    PNG. The JAX model runs at the highest matmul precision (conftest)."""
    enc_p, enc_s = j_irse.init(jax.random.PRNGKey(0))
    rec_p, rec_s = j_recnet.init(jax.random.PRNGKey(1))
    jopts = _options(JaxOptions, lfw_tree, tmp_path / "j")
    jrec = Recorder()
    j_train.log_attention_visual(jopts, (enc_p, enc_s), (rec_p, rec_s), jopts.trainer_config(),
                                 jrec, 3)

    enc_p, enc_s, rec_p, rec_s = jax.device_get((enc_p, enc_s, rec_p, rec_s))
    enc = build_backbone()
    enc.load_state_dict(backbone_state_dict(enc_p, enc_s))
    rec = build_recnet(RecNetConfig())
    rec.load_state_dict(recnet_state_dict(rec_p, rec_s))
    rec.train()
    topts = _options(TorchOptions, lfw_tree, tmp_path / "t", device="cpu")
    trec = Recorder()
    t_train.log_attention_visual(topts, enc.eval(), rec, trec, 3)
    assert rec.training  # back in train mode

    got, want = trec.images["attention/ocl1"], jrec.images["attention/ocl1"]
    assert got.shape == want.shape == (8 * 112, 8 * 112, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16)).reshape(8 * 112, 8, 112, 3)
    # every column within one uint8 level: the panel truncates to uint8, so
    # values a rounding apart on either side of a level differ by one.
    # Image columns (0, 4): JAX's jitted (x/255 - 0.5)/0.5 multiplies by
    # XLA's reciprocal of 255, 1 ulp off the port's IEEE division on 205 of
    # the 256 pixel values, and (u + 1) * 127.5 then truncates to another
    # level for 31 of them. Attention columns: fp32 sums in another order.
    assert diff.max() <= 1
    attention = diff[:, [1, 2, 3, 5, 6, 7]]
    assert (attention > 0).mean() < 1e-3
    for opts in (jopts, topts):
        assert os.path.exists(os.path.join(opts.ckpt_dir, "visuals", "attention_0000003.png"))


def test_driver_visualize_flag_writes_the_panel(lfw_tree, tmp_path, monkeypatch):
    """--visualize 1 in a run from files: the panel is logged at each eval
    and its PNG written; the run trains on."""
    from test_torch_driver import StandIn

    monkeypatch.setattr(t_train, "load_encoder", lambda opts, device: StandIn().to(device).eval())
    recorded = []
    real = t_train.log_attention_visual

    def spy(opts, encoder, recnet, logger, iteration):
        real(opts, encoder, recnet, logger, iteration)
        recorded.append((iteration, recnet.training))

    monkeypatch.setattr(t_train, "log_attention_visual", spy)
    opts = TorchOptions(phase="train", train_data="synthetic", num_classes=4, batch_size=4,
                        total_epochs=1, optimizer="adam", lr=1e-3, save_freq=100, print_freq=100,
                        eval_freq=2, n_thread=2, seed=0, visualize=1, device="cpu",
                        test_data=str(lfw_tree[0]), test_pair_list=str(lfw_tree[1]),
                        weight_root=str(tmp_path / "w"), debug=0).finalize()
    t_train.train(opts)
    assert recorded and all(training for _, training in recorded)
    pngs = sorted(os.listdir(os.path.join(opts.ckpt_dir, "visuals")))
    assert pngs == [f"attention_{it:07d}.png" for it, _ in recorded]
