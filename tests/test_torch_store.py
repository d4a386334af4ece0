"""The port's checkpoint store (ffrnet_torch.checkpoint.store) on the CPU: its
own round trip, 'latest' resolution, the optimizer-state checks, and
checkpoints read across packages both ways against ffrnet_tpu's store."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ffrnet_torch.checkpoint import store
from ffrnet_torch.checkpoint.convert import (optimizer_state_from_leaves,
                                             recnet_state_dict, train_state_dicts)
from ffrnet_torch.models.recnet import RecNetConfig
from ffrnet_torch.training.trainer import (TrainerConfig, create_train_state,
                                           load_train_state, train_step_from_features)
from ffrnet_tpu.checkpoint.store import load_checkpoint as j_load_checkpoint
from ffrnet_tpu.checkpoint.store import save_checkpoint as j_save_checkpoint
from ffrnet_tpu.models.recnet import RecNetConfig as JRecNetConfig
from ffrnet_tpu.training import trainer as j_trainer

torch.set_num_threads(1)

# (optimizer, momentum): SGD also without momentum (an empty state)
OPTIMIZERS = [("adam", 0.9), ("sgd", 0.9), ("sgd", 0.0), ("rmsprop", 0.9), ("adabound", 0.9)]


def features(n=2, classes=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"featmap_non": torch.randn(n, 512, 7, 7, generator=g),
            "featmap_ocl": torch.randn(n, 512, 7, 7, generator=g),
            "embed_non": torch.randn(n, 512, generator=g),
            "embed_ocl": torch.randn(n, 512, generator=g),
            "label": torch.arange(n) % classes}


def port_cfg(optimizer, momentum, classes=8):
    return TrainerConfig(optimizer=optimizer, momentum=momentum, lr=1e-3,
                         recnet=RecNetConfig(num_classes=classes))


def assert_opt_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].keys() == b[key].keys(), key
        for entry, v in a[key].items():
            w = b[key][entry]
            if isinstance(v, torch.Tensor):
                assert v.dtype == w.dtype and torch.equal(v, w.to(v.device)), (key, entry)
            else:
                assert v == w, (key, entry)


@pytest.mark.parametrize("optimizer,momentum", [("adam", 0.9), ("adabound", 0.9)])
def test_round_trip_is_exact(tmp_path, optimizer, momentum):
    cfg = port_cfg(optimizer, momentum)
    state = create_train_state(cfg, seed=3, device="cpu")
    for s in range(2):
        train_step_from_features(state, features(seed=s), cfg=cfg)
    path = store.save_checkpoint(str(tmp_path), "0000002", model=state.model,
                                 optimizer=state.optimizer.inner, epoch=1, iteration=2)
    assert os.path.basename(path) == "0000002.pth.gzip"
    assert os.listdir(tmp_path) == ["0000002.pth.gzip"]  # no tmp file left

    sd, opt, meta = store.load_checkpoint(str(tmp_path), "latest")
    assert meta == {"epoch": 1, "iter": 2}
    fresh = create_train_state(cfg, seed=4, device="cpu")
    load_train_state(fresh, sd, store.optimizer_state(opt, optimizer, fresh.model, 2), 2)
    want = state.model.state_dict()
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    saved = store.optimizer_state_by_key(state.model, state.optimizer.inner)
    assert_opt_equal(store.optimizer_state_by_key(fresh.model, fresh.optimizer.inner), saved)
    assert fresh.step == 2
    # the restored state takes the same next update
    for st in (state, fresh):
        train_step_from_features(st, features(seed=9), cfg=cfg)
    want = state.model.state_dict()
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_resolve_latest(tmp_path):
    d = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        store.resolve_latest(d)
    for name in ("0000004.pth.gzip", "0000008.pth.gzip", "latest.pth.gzip",
                 ".zzzz.tmp.123.pth.gzip", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    # a crashed write's dot-file never resolves, however it sorts
    assert store.resolve_latest(d) == os.path.join(d, "latest.pth.gzip")
    os.remove(tmp_path / "latest.pth.gzip")
    assert store.resolve_latest(d) == os.path.join(d, "0000008.pth.gzip")
    assert store.resolve_latest(d, "0000004") == os.path.join(d, "0000004.pth.gzip")
    assert store.resolve_latest(d, "0000004.pth.gzip") == os.path.join(d, "0000004.pth.gzip")
    assert store.resolve_latest(d, "/x/y.pth.gzip") == "/x/y.pth.gzip"


def test_optimizer_state_rejects_what_does_not_fit(tmp_path):
    cfg = port_cfg("adam", 0.9)
    state = create_train_state(cfg, seed=3, device="cpu")
    train_step_from_features(state, features(), cfg=cfg)
    store.save_checkpoint(str(tmp_path), "latest", model=state.model,
                          optimizer=state.optimizer.inner, iteration=1)
    _, opt, _ = store.load_checkpoint(str(tmp_path))
    other = create_train_state(port_cfg("adam", 0.9, classes=9), device="cpu")
    with pytest.raises(ValueError, match=r"classifier\.weight/exp_avg.*\(8, 512\) vs "
                                         r"expected \(9, 512\)"):
        store.optimizer_state(opt, "adam", other.model, 1)
    with pytest.raises(ValueError, match="different optimizer"):
        store.optimizer_state(opt, "sgd", state.model, 1)
    with pytest.raises(ValueError, match="no parameter"):
        store.optimizer_state({"nope.weight": {}}, "adam", state.model, 1)
    # the JAX package's flat leaves: count and shapes
    sd = state.model.state_dict()
    jst = j_trainer.create_train_state(jax.random.PRNGKey(0), j_trainer.TrainerConfig(
        optimizer="adam", recnet=JRecNetConfig(num_classes=9)))
    leaves = [np.asarray(x) for x in jax.tree.leaves(jst.opt_state)]
    with pytest.raises(ValueError, match=r"leaf 1 \(exp_avg of classifier/w\).*"
                                         r"\(9, 512\) vs expected \(8, 512\)"):
        optimizer_state_from_leaves("adam", leaves, sd, 1)
    with pytest.raises(ValueError, match="154 leaves expected.*has 153"):
        optimizer_state_from_leaves("adam", leaves[:-1], sd, 1)


def jax_state(optimizer, momentum, seed=0):
    """A JAX TrainState (8 classes) with random BN stats and random
    optimizer moments, so that every number crossing is a distinct one."""
    cfg = j_trainer.TrainerConfig(optimizer=optimizer, momentum=momentum,
                                  recnet=JRecNetConfig(num_classes=8))
    st = j_trainer.create_train_state(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)

    def noise(x, positive=False):
        x = np.asarray(x)
        if not np.issubdtype(x.dtype, np.floating):
            return x + 5
        r = rng.standard_normal(x.shape).astype(x.dtype)
        return np.abs(r) + 0.5 if positive else r

    model_state = jax.tree_util.tree_map_with_path(
        lambda p, x: noise(x, positive="var" in jax.tree_util.keystr(p)), st.model_state)
    return st._replace(model_state=model_state, opt_state=jax.tree.map(noise, st.opt_state),
                       step=jnp.asarray(7, jnp.int32))


@pytest.mark.parametrize("optimizer,momentum", OPTIMIZERS)
def test_optax_leaves_map_like_train_state_dicts(optimizer, momentum):
    """The flat optax leaves, mapped by leaf order onto the port's
    per-parameter state, equal what train_state_dicts gives from the
    optax state itself."""
    st = jax_state(optimizer, momentum)
    want_sd, want_opt, step = train_state_dicts(*jax.device_get(st), optimizer)
    leaves = [torch.from_numpy(np.array(x)) for x in jax.tree.leaves(st.opt_state)]
    assert_opt_equal(optimizer_state_from_leaves(optimizer, leaves, want_sd, step), want_opt)


def test_reads_a_jax_checkpoint(tmp_path):
    """(a) a checkpoint of ffrnet_tpu's store loads into the port: RecNet's
    parameters, BN stats and epoch/iter exact, and its optimizer state
    (Adam moments from the flat optax leaves) equal to what
    train_state_dicts gives from the same JAX state."""
    st = jax_state("adam", 0.9)
    j_save_checkpoint(str(tmp_path), "0000007", params=st.params,
                      model_state=st.model_state, opt_state=st.opt_state, epoch=2,
                      iteration=7)
    sd, leaves, meta = store.load_checkpoint(str(tmp_path), "0000007")
    assert meta == {"epoch": 2, "iter": 7}
    assert isinstance(leaves, list)
    want_sd, want_opt, step = train_state_dicts(*jax.device_get(st), "adam")
    assert sd.keys() == want_sd.keys()
    for k, v in want_sd.items():
        assert torch.equal(sd[k], v), k
    state = create_train_state(port_cfg("adam", 0.9), device="cpu")
    opt = store.optimizer_state(leaves, "adam", state.model, meta["iter"])
    assert_opt_equal(opt, want_opt)
    load_train_state(state, sd, opt, meta["iter"])
    assert state.step == step == 7


def test_jax_reads_a_port_checkpoint(tmp_path):
    """(b) a checkpoint the port wrote loads through
    ffrnet_tpu.checkpoint.store.load_checkpoint into the same RecNet."""
    cfg = port_cfg("adam", 0.9)
    state = create_train_state(cfg, seed=5, device="cpu")
    train_step_from_features(state, features(), cfg=cfg)
    store.save_checkpoint(str(tmp_path), "latest", model=state.model,
                          optimizer=state.optimizer.inner, epoch=3, iteration=1)
    params, model_state, opt_leaves, meta = j_load_checkpoint(str(tmp_path), "latest")
    assert meta == {"epoch": 3, "iter": 1}
    assert opt_leaves is None  # the port's optimizer state is under its own key
    got = recnet_state_dict(params, model_state)
    want = state.model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        if "num_batches_tracked" not in k:  # the JAX tree has no such counter
            assert torch.equal(got[k], v), k
