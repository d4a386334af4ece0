"""The port's parity_check against ffrnet_tpu's on the CPU, on `.pth` files
that the port's save_pth writes from seeded JAX trees (the released
se50.pth and FFRNet.pth are not in the repository): the JAX package's
torch-free reader reads them back bit for bit; embed_norm against the JAX
tool's compare_with_torch at 1e-5 rel; the feature map, raw and rectified
embeddings against irse.apply and recnet.apply at 1e-5; int8_gate's
boundary cases. run_lfw: test_torch_parity_lfw.py (float) and
test_torch_parity_int8.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ffrnet_torch.checkpoint.pth_io import save_pth
from ffrnet_torch.tools import parity_check
from ffrnet_tpu.checkpoint.pth_io import load_pth as j_load_pth
from ffrnet_tpu.checkpoint.torch_convert import (backbone_from_torch, backbone_to_torch,
                                                 recnet_from_torch, recnet_to_torch)
from ffrnet_tpu.models import irse as jirse
from ffrnet_tpu.models import recnet as jrecnet
from ffrnet_tpu.tools import parity_check as j_parity_check

torch.set_num_threads(2)

TOL = 1e-5


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(encoder .pth, RecNet .pth, their numpy state dicts): JAX's
    irse.init(key 0) and recnet.init(key 1) through the JAX package's
    converters, written by the port's save_pth; the encoder as a plain
    state dict, RecNet wrapped as {"RecNet": ...} (the released files'
    two layouts)."""
    root = tmp_path_factory.mktemp("weights")
    enc_sd = backbone_to_torch(*jax.device_get(jirse.init(jax.random.PRNGKey(0))))
    rec_sd = recnet_to_torch(*jax.device_get(jrecnet.init(jax.random.PRNGKey(1))))
    enc_path, rec_path = str(root / "se50.pth"), str(root / "FFRNet.pth")
    save_pth({k: torch.from_numpy(np.array(v)) for k, v in enc_sd.items()}, enc_path)
    save_pth({"RecNet": {k: torch.from_numpy(np.array(v)) for k, v in rec_sd.items()}},
             rec_path)
    return enc_path, rec_path, enc_sd, rec_sd


def test_jax_reader_reads_save_pth_files(weights):
    """ffrnet_tpu/checkpoint/pth_io.py (no torch) reads what the port's
    save_pth wrote: the same keys, dtypes, shapes and bytes."""
    enc_path, rec_path, enc_sd, rec_sd = weights
    for got, want in ((j_load_pth(enc_path), enc_sd), (j_load_pth(rec_path)["RecNet"], rec_sd)):
        assert set(got) == set(want)
        for k, v in want.items():
            g, w = np.asarray(got[k]), np.asarray(v)
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k


@pytest.fixture(scope="module")
def jax_outputs(weights):
    """(featmap NCHW, embed, rectified) of the JAX stack on parity_check's
    inputs, from the files through the JAX package's reader."""
    enc_path, rec_path, _, _ = weights
    enc_p, enc_s = backbone_from_torch(j_load_pth(enc_path))
    rec_p, rec_s = recnet_from_torch(j_load_pth(rec_path)["RecNet"])
    x = parity_check.inputs(4, 0)
    featmap, embed, _ = jax.jit(jirse.apply)(enc_p, enc_s, jnp.asarray(x.transpose(0, 2, 3, 1)))
    (rect, _), _ = jax.jit(jrecnet.apply)(rec_p, rec_s, featmap)
    return (np.asarray(featmap).transpose(0, 3, 1, 2), np.asarray(embed), np.asarray(rect))


def test_outputs_match_jax(weights, jax_outputs):
    enc_path, rec_path, _, _ = weights
    model = parity_check.load_model(enc_path, rec_path, "cpu")
    got = parity_check.outputs(model, parity_check.inputs(4, 0), True)
    for name, g, w in zip(("featmap", "embed", "rectified"), got, jax_outputs):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL, err_msg=name)


def test_compare_with_torch_embed_norm_matches_jax_tool(weights, jax_outputs):
    """embed_norm against the JAX tool's on the same files; on the CPU the
    card comparison gives way to a 'skipped' note, as the JAX tool's does
    without the reference checkout."""
    enc_path, rec_path, _, _ = weights
    ours = parity_check.compare_with_torch(enc_path, rec_path, device="cpu")
    theirs = j_parity_check.compare_with_torch(enc_path, rec_path)
    assert set(ours) == {"embed_norm", "torch_comparison"}
    assert ours["torch_comparison"].startswith("skipped (")
    assert theirs["torch_comparison"].startswith("skipped (")
    assert ours["embed_norm"] == pytest.approx(theirs["embed_norm"], rel=TOL, abs=0)
    assert ours["embed_norm"] == pytest.approx(float(np.linalg.norm(jax_outputs[1][0])),
                                               rel=TOL, abs=0)


def test_int8_gate_uses_unrounded_deltas():
    """The boundary cases of tests/test_optimize_and_tools.py::
    test_parity_gate_uses_unrounded_deltas, through the port's gate."""
    int8_gate = parity_check.int8_gate
    # boundary: |unrounded delta| 0.00104 > budget, displays as 0.001
    shown, within = int8_gate(acc_new=0.99000, acc=0.98000,
                              acc_new_int8=0.99104, acc_int8=0.98000)
    assert shown == [0.001, 0.0]
    assert within is False
    # under budget passes (0.991 - 0.99 is 0.001000...0009 in binary: over)
    shown, within = int8_gate(0.99, 0.98, 0.9908, 0.98)
    assert shown == [0.0008, 0.0] and within is True
    # sign does not matter
    _, within = int8_gate(0.99, 0.98, 0.98896, 0.98)
    assert within is False


@pytest.mark.parametrize("args", [(0.99, 0.98, 0.99104, 0.98), (0.99, 0.98, 0.9908, 0.98),
                                  (0.99, 0.98, 0.98896, 0.98), (0.5, 0.6, 0.5, 0.601),
                                  (1.0, 1.0, 0.999, 1.0)])
def test_int8_gate_is_the_jax_tools(args):
    assert parity_check.int8_gate(*args) == j_parity_check.int8_gate(*args)
