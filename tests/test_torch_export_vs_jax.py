"""The port's exported program (ffrnet_torch/tools/export_model.py) against the
JAX package's StableHLO artifact (ffrnet_tpu/tools/export_model.py) on the CPU.

Both packages export FFRNet.random(0)'s weights with a symbolic batch; the
JAX artifact is deserialized, the port's program saved and loaded, and both
are called on the same numpy faces.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from ffrnet_torch.api import FFRNet
from ffrnet_torch.checkpoint.convert import backbone_state_dict, recnet_state_dict
from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.models.recnet import RecNetConfig, build_recnet
from ffrnet_torch.tools.export_model import export_embed
from tests.test_torch_export import faces, reload

torch.set_num_threads(1)

# fp32 on both sides, two implementations of the same embedding: the bound
# of tests/test_torch_api_eval.py
EMB_TOL = dict(atol=5e-5, rtol=0)


def test_matches_the_jax_export():
    """The JAX package's FFRNet.random(0) exported by its tool and
    deserialized, against the port's loaded program on the same weights
    (checkpoint/convert.py), at N=3."""
    from jax import export as jex

    from ffrnet_tpu.api import FFRNet as JaxFFRNet
    from ffrnet_tpu.tools.export_model import export_embed as jax_export_embed

    jm = JaxFFRNet.random(seed=0)
    artifact = jex.deserialize(jax_export_embed(jm, symbolic_batch=True).serialize())
    enc_p, enc_s, rec_p, rec_s = jax.device_get(
        (jm.enc_params, jm.enc_state, jm.rec_params, jm.rec_state))
    enc = build_backbone()
    enc.load_state_dict(backbone_state_dict(enc_p, enc_s))
    rec = build_recnet()
    rec.load_state_dict(recnet_state_dict(rec_p, rec_s))
    model = FFRNet(enc, rec, RecNetConfig(), "cpu").prepare()
    program = reload(export_embed(model))
    x = faces(3, 13)
    want = artifact.call(jnp.asarray(x))
    with torch.no_grad():
        got = program.module()(torch.from_numpy(x))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **EMB_TOL)
