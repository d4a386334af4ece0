"""The port's driver against ffrnet_tpu's driver on the CPU, end to end from
files: the same se50.pth and RecNet .pth (the JAX package's random init,
irse.init(PRNGKey(0)) and recnet.init(PRNGKey(1)), as the other parity
tests take them), the same synthetic data (8 samples, batch 4, uint8 to
the device), two plain SGD steps (lr 1e-3, no momentum) in each,
checkpoints written by each store; RecNet's state dicts within 1e-5.

The first step's losses agree to the bit; the second step's parameters
carry the first update's gradient, which is ill-conditioned in fp32 at
ChannelFlipMerge.0 (ROADMAP Queue 3, "Not a fault"): at lr 1e-2 that
weight ends 1.1e-5 apart, about 1% of its move, the rest within 9e-6."""

import numpy as np
import torch

import jax

from ffrnet_torch import train as train_mod
from ffrnet_torch.checkpoint.store import load_checkpoint
from ffrnet_torch.config import Options
from ffrnet_tpu import train as j_train
from ffrnet_tpu.checkpoint.torch_convert import backbone_to_torch, recnet_to_torch
from ffrnet_tpu.config import Options as JOptions
from ffrnet_tpu.models import irse, recnet
from ffrnet_tpu.models.recnet import RecNetConfig as JRecNetConfig

torch.set_num_threads(2)


def _synthetic(jax_side=False):
    if jax_side:
        from ffrnet_tpu.data.datasets import SyntheticPairs
    else:
        from ffrnet_torch.data.datasets import SyntheticPairs
    return SyntheticPairs(num_identities=2, host_normalize=False)


def test_drivers_agree_after_two_sgd_steps(tmp_path, monkeypatch):
    def tensors(sd):
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}

    se50 = str(tmp_path / "se50.pth")
    torch.save(tensors(backbone_to_torch(*jax.device_get(irse.init(jax.random.PRNGKey(0))))),
               se50)
    init = tensors(recnet_to_torch(*jax.device_get(
        recnet.init(jax.random.PRNGKey(1), JRecNetConfig(num_classes=8)))))
    ffr = str(tmp_path / "FFRNet.pth")
    torch.save({"RecNet": init}, ffr)
    monkeypatch.chdir(tmp_path)
    kw = dict(phase="train", train_data="synthetic", num_classes=8, batch_size=4,
              total_epochs=1, optimizer="sgd", lr=1e-3, momentum=0.0, save_freq=2,
              print_freq=1000, eval_freq=0, n_thread=2, seed=0, encoder_weights=se50,
              recnet_weights=ffr, mesh_data=1)
    port = Options(device="cpu", weight_root=str(tmp_path / "p"), **kw).finalize()
    jopts = JOptions(weight_root=str(tmp_path / "j"), **kw).finalize()
    # 2 identities x 4 samples = 8 samples: two steps of batch 4 (the
    # driver's own synthetic set would take min(num_classes, 64) identities)
    monkeypatch.setattr(train_mod, "make_train_dataset", lambda o: _synthetic())
    monkeypatch.setattr(j_train, "make_train_dataset", lambda o: _synthetic(jax_side=True))
    train_mod.train(port)
    j_train.train(jopts)
    got, _, meta = load_checkpoint(port.ckpt_dir, "0000002")
    want, _, jmeta = load_checkpoint(jopts.ckpt_dir, "0000002")
    assert meta == jmeta == {"epoch": 0, "iter": 2}
    moved = 0.0
    for k, v in want.items():
        if v.is_floating_point():
            torch.testing.assert_close(got[k], v, atol=1e-5, rtol=0, msg=k)
            moved = max(moved, (v - init[k]).abs().max().item())
    assert moved > 5e-5  # the steps moved the weights
