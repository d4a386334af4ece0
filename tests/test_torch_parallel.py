"""ffrnet_torch.parallel and the data-parallel inference on the CPU, in one
process, against ffrnet_tpu:

  * the mesh shapes and their messages against ffrnet_tpu's make_mesh over
    8 virtual CPU devices (tests/test_training.py:792-807), and
    validate_batch_for_mesh's message; outside a process group the mesh is
    one rank and an oversized one raises
  * FFRNet.shard(devices=["cpu", "cpu"]) against embed (the pad of 11
    faces, prepare keeping the sharding, verify, an EmbeddingService over
    the sharded model; 2e-5, the JAX package's bound,
    tests/test_serving.py:36-72, :160) and against ffrnet_tpu's sharded
    model on the same weights (5e-5, the two packages' serving bound)
  * evaluate_pairs_multiprocess at world size 1: the same fold results as
    ffrnet_tpu's, and the count mismatch raised after the gather
    (tests/test_eval_protocol.py:315)
"""

import types

import numpy as np
import pytest
import torch

import jax

from ffrnet_torch import parallel
from ffrnet_torch.api import FFRNet
from ffrnet_torch.checkpoint.convert import backbone_state_dict, recnet_state_dict
from ffrnet_torch.eval import runner
from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.models.recnet import RecNetConfig, build_recnet
from ffrnet_torch.serving import EmbeddingService
from ffrnet_tpu.api import FFRNet as JaxFFRNet
from ffrnet_tpu.parallel import mesh as j_mesh

torch.set_num_threads(1)

SHARD_TOL = dict(atol=2e-5, rtol=2e-5)   # sharded vs one device (tests/test_serving.py)
JAX_TOL = dict(atol=5e-5, rtol=0)        # fp32 embeddings, the two packages


def _faces(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 112, 112, 3)).astype(np.float32)


# ------------------------------------------------------------------- mesh


MESH_CASES = [(None, 16), (4, 4), (None, 0), (None, 3), (4, 2), (None, 1), (2, 1), (9, 1),
              (0, 1), (3, 3)]


@pytest.mark.parametrize("n_data,n_model", MESH_CASES)
def test_mesh_dims_match_jax_make_mesh(n_data, n_model, capfd):
    """Over 8 devices: the same shape, or the same ValueError message, and
    the same idle-device warning."""
    try:
        want = j_mesh.make_mesh(n_data, n_model, devices=jax.devices()[:8]).shape
    except ValueError as e:
        want = str(e)
    j_err = capfd.readouterr().err
    try:
        got = dict(zip(("data", "model"), parallel.mesh_dims(n_data, n_model, 8)))
    except ValueError as e:
        got = str(e)
    assert got == want
    warn = [line for line in j_err.splitlines() if "idle" in line]
    assert [line for line in capfd.readouterr().err.splitlines() if "idle" in line] == warn


def test_make_mesh_outside_a_process_group():
    mesh = parallel.make_mesh()
    assert parallel.mesh_axes(mesh) == {"data": 1, "model": 1}
    assert parallel.data_group(mesh) is None
    assert parallel.world_size() == 1 and parallel.rank() == 0
    for kw in ({"n_data": 2}, {"n_model": 2}):
        try:
            j_mesh.make_mesh(devices=jax.devices()[:1], **kw)
        except ValueError as e:
            want = str(e)
        with pytest.raises(ValueError) as got:
            parallel.make_mesh(**kw)
        assert str(got.value) == want


def test_validate_batch_for_mesh_matches_jax():
    jm = j_mesh.make_mesh(4, 2, devices=jax.devices()[:8])
    tm = types.SimpleNamespace(shape=(4, 2), mesh_dim_names=("data", "model"))
    for batch, flag in ((6, "--batch_size"), (10, "--eval_batch")):
        with pytest.raises(ValueError) as want:
            j_mesh.validate_batch_for_mesh(jm, batch, flag)
        with pytest.raises(ValueError) as got:
            parallel.validate_batch_for_mesh(tm, batch, flag)
        assert str(got.value) == str(want.value)
    parallel.validate_batch_for_mesh(tm, 8)


# ------------------------------------------------------------------ shard


@pytest.fixture(scope="module")
def models():
    """(ffrnet_tpu's FFRNet.random(0) sharded over 8 virtual devices, the
    port holding its weights, the port sharded over two CPU 'devices')."""
    jm = JaxFFRNet.random(seed=0)
    enc_p, enc_s, rec_p, rec_s = jax.device_get(
        (jm.enc_params, jm.enc_state, jm.rec_params, jm.rec_state))
    enc = build_backbone()
    enc.load_state_dict(backbone_state_dict(enc_p, enc_s))
    rec = build_recnet()
    rec.load_state_dict(recnet_state_dict(rec_p, rec_s))
    tm = FFRNet(enc, rec, RecNetConfig(), "cpu").prepare()
    return jm.shard(j_mesh.make_mesh()), tm, tm.shard(["cpu", "cpu"])


def test_shard_replicates_over_the_devices(models):
    _, tm, sharded = models
    assert sharded.devices == (torch.device("cpu"),) * 2 and tm.devices == (tm.device,)
    (_, enc1, rec1), = sharded.replicas
    assert enc1 is not sharded.encoder and rec1 is not sharded.recnet
    for a, b in zip(enc1.state_dict().values(), sharded.encoder.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="is_available"):
        tm.shard()  # every visible card: there is none


@pytest.mark.parametrize("n,seed", [(8, 0), (11, 3)], ids=["even", "padded"])
def test_sharded_embed_matches_embed_and_jax(models, n, seed):
    """8 faces split 4 + 4; 11 padded to 12, split 6 + 6, sliced back."""
    jsharded, tm, sharded = models
    x = _faces(n, seed)
    raw0, rect0 = tm.embed(x)
    raw1, rect1 = sharded.embed(x)
    assert raw1.shape == rect1.shape == (n, 512)
    torch.testing.assert_close(raw1, raw0, **SHARD_TOL)
    torch.testing.assert_close(rect1, rect0, **SHARD_TOL)
    j_raw, j_rect = jsharded.embed(x)
    np.testing.assert_allclose(raw1.numpy(), np.asarray(j_raw), **JAX_TOL)
    np.testing.assert_allclose(rect1.numpy(), np.asarray(j_rect), **JAX_TOL)


def test_prepare_preserves_sharding(models):
    _, _, sharded = models
    bf16 = sharded.prepare(dtype=torch.bfloat16)
    assert bf16.devices == sharded.devices and len(bf16.replicas) == 1
    assert all(p.dtype == torch.bfloat16 for _, enc, _ in bf16.replicas
               for p in enc.parameters())
    raw, _ = bf16.embed(_faces(8, seed=4))
    assert raw.shape == (8, 512) and raw.dtype == torch.bfloat16


def test_sharded_verify(models):
    _, tm, sharded = models
    a, b = _faces(3, seed=1), _faces(3, seed=2)  # 2N = 6, 3 faces a device
    torch.testing.assert_close(sharded.verify(a, b), tm.verify(a, b), **SHARD_TOL)


def test_service_over_sharded_model(models):
    _, tm, sharded = models
    x = _faces(5, seed=17)
    raw0, _ = tm.embed(x)
    with EmbeddingService(sharded, max_batch=8, max_delay_s=0.01) as svc:
        outs = [f.result(timeout=120) for f in [svc.submit(x[i]) for i in range(5)]]
    for i, (raw, _) in enumerate(outs):
        torch.testing.assert_close(raw[0], raw0[i], **SHARD_TOL)


# ------------------------------------------------------------------- eval


def _score_batches(n, seed=0, size=7):
    rng = np.random.default_rng(seed)
    raw = rng.uniform(-1, 1, n).astype(np.float32)
    new = (rng.uniform(-1, 1, n) // 0.005 * 0.005).astype(np.float32)
    lab = rng.integers(0, 2, n).astype(np.int64)
    return [{"img1": raw[s:s + size], "img2": new[s:s + size], "label": lab[s:s + size]}
            for s in range(0, n, size)]


def _t_score(a, b):
    return torch.as_tensor(a), torch.as_tensor(b)


def _j_score(e_p, e_s, r_p, r_s, a, b):
    return a, b


def test_multiprocess_eval_at_world_size_1_matches_jax():
    from ffrnet_tpu.eval.runner import evaluate_pairs_multiprocess as j_multi

    batches = _score_batches(61)
    got = runner.evaluate_pairs_multiprocess(_t_score, batches, n_pairs=61, return_scores=True)
    want = j_multi(None, None, None, None, batches, n_pairs=61, score_fn=_j_score,
                   return_scores=True, process_index=0, process_count=1)
    single = runner.evaluate_pairs(_t_score, batches)
    for r, jr, sr in zip(got[:2], want[:2], single):
        for a, b, c in zip(r, jr, sr):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(a.numpy(), c.numpy())
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_multiprocess_size_mismatch_fails_after_collective(monkeypatch):
    """A process that feeds 10 pairs of the 30 it owns raises the JAX
    package's count diagnostic, after the gather: raising before it would
    leave every other process waiting in the collective."""
    from ffrnet_tpu.eval.runner import evaluate_pairs_multiprocess as j_multi

    gathered = []
    real = runner._all_gather_host

    def spy(payload, group):
        gathered.append(payload.shape)
        return real(payload, group)

    monkeypatch.setattr(runner, "_all_gather_host", spy)
    batches = _score_batches(10)
    with pytest.raises(ValueError, match="per-process pair counts") as got:
        runner.evaluate_pairs_multiprocess(_t_score, batches, n_pairs=30)
    assert gathered == [(3 * 30 + 1,)]  # the agreed shape: raw, rect, labels, count
    with pytest.raises(ValueError) as want:
        j_multi(None, None, None, None, batches, n_pairs=30, score_fn=_j_score,
                process_index=0, process_count=1)
    assert str(got.value) == str(want.value)
