"""Sharded checkpoints on torch.distributed.checkpoint
(ffrnet_torch/checkpoint/orbax_io.py) against ffrnet_tpu's orbax_io.

  * one process: train_state_tree -> save_orbax -> load_orbax is bit-equal
    for the parameters, the running stats, the optimizer state (SGD with
    momentum, Adam, AdaBound), step, epoch and iter, and loads back into a
    TrainState bit for bit
  * latest_orbax_step and prune_orbax against ffrnet_tpu's on the same
    directory names (those two JAX functions read names only); a directory
    without DCP's .metadata, and a save still under its temporary name, are
    never the latest
  * two gloo ranks (tests/torch_distributed_worker.py `orbax`): one Adam
    step on a 1x2 mesh with 13 classes, saved without gathering (the
    metadata holds the classifier and its moments as 2 chunks of 7 and 6
    rows, the replicated tensors as one), then loaded under 1x2, under 2x1
    and in this process, each bit-equal to the gathered state
  * a padding larger than one shard (5 classes over 4 shards, written by
    the `head` ranks of tests/test_torch_model_axis.py's worker run here
    anew): the layout is DTensor's and loads whole
"""

import os
import shutil

import numpy as np
import pytest
import torch

from ffrnet_torch.checkpoint import orbax_io
from ffrnet_torch.models.recnet import RecNetConfig
from ffrnet_torch.parallel import make_mesh
from ffrnet_torch.training.trainer import (TrainerConfig, create_train_state, load_train_state,
                                           train_step_from_features)
from ffrnet_tpu.checkpoint import orbax_io as j_orbax_io
from torch_distributed_worker import join_ranks, start_ranks

torch.set_num_threads(1)

NUM = 13


@pytest.fixture
def scratch(tmp_path):
    """tmp_path, emptied after the test: a RecNet state is 120-280 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def feats(n=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"featmap_non": torch.randn(n, 512, 7, 7, generator=g),
            "featmap_ocl": torch.randn(n, 512, 7, 7, generator=g),
            "embed_non": torch.nn.functional.normalize(torch.randn(n, 512, generator=g), dim=1),
            "embed_ocl": torch.nn.functional.normalize(torch.randn(n, 512, generator=g), dim=1),
            "label": torch.tensor([1, 12])}


def _equal(a, b):
    return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.mark.parametrize("optimizer", ["sgd", "adam", "adabound"])
def test_one_process_round_trip_is_bit_equal(optimizer, scratch):
    cfg = TrainerConfig(optimizer=optimizer, lr=1e-3, momentum=0.9,
                        recnet=RecNetConfig(num_classes=NUM))
    state = create_train_state(cfg, device="cpu")
    train_step_from_features(state, feats(), cfg=cfg)
    tree = orbax_io.train_state_tree(state, make_mesh(), epoch=3, iteration=7)
    path = orbax_io.save_orbax(str(scratch), 7, tree)
    assert sorted(os.listdir(scratch)) == ["orbax_000000007"]
    assert sorted(os.listdir(path)) == [".metadata", "__0_0.distcp"]
    back = orbax_io.load_orbax(str(scratch))
    assert back.keys() == tree.keys()
    for k, v in tree.items():
        assert _equal(back[k], v), k
    sd, opt, meta = orbax_io.state_dicts_from_tree(back)
    assert meta == {"epoch": 3, "iter": 7, "step": 1}
    assert any(k.startswith("model_state/") and "running_mean" in k for k in tree)
    entries = {"sgd": {"momentum_buffer"}, "adam": {"step", "exp_avg", "exp_avg_sq"},
               "adabound": {"step", "exp_avg", "exp_avg_sq"}}[optimizer]
    assert opt.keys() == dict(state.model.named_parameters()).keys()
    assert all(set(st) == entries for st in opt.values())
    fresh = load_train_state(create_train_state(cfg, seed=5, device="cpu"), sd, opt,
                             meta["step"])
    for (k, v), w in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(v, w), k
    params = dict(fresh.model.named_parameters())
    for p, st in state.optimizer.inner.state.items():
        q = params[next(k for k, x in state.model.named_parameters() if x is p)]
        for e, v in st.items():
            assert _equal(fresh.optimizer.inner.state[q][e], v), e
    assert fresh.step == state.step


def _mkdirs(root, steps, complete=True):
    for s in steps:
        d = os.path.join(root, f"orbax_{s:09d}")
        os.makedirs(d)
        if complete:
            open(os.path.join(d, ".metadata"), "wb").close()


@pytest.mark.parametrize("steps,keep_every,keep_last", [
    (range(1, 9), 4, 2), (range(1, 17), 4, 2), ([2, 4, 5, 6, 9, 12], 3, 1),
    (range(1, 6), 0, 2), (range(1, 6), 2, 0), ([10, 20], 4, 5)])
def test_prune_and_latest_match_jax(steps, keep_every, keep_last, tmp_path):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    for root in (mine, theirs):
        _mkdirs(root, steps)
    assert orbax_io.latest_orbax_step(mine) == j_orbax_io.latest_orbax_step(theirs)
    n = orbax_io.prune_orbax(mine, keep_every=keep_every, keep_last=keep_last)
    assert n == j_orbax_io.prune_orbax(theirs, keep_every=keep_every, keep_last=keep_last)
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    assert orbax_io.latest_orbax_step(mine) == j_orbax_io.latest_orbax_step(theirs)


def test_incomplete_saves_are_never_latest(scratch):
    """A step directory without .metadata (a crash inside DCP's save) and a
    save under its temporary name are skipped by latest_orbax_step,
    load_orbax(step=None) and prune_orbax."""
    cfg = TrainerConfig(recnet=RecNetConfig(num_classes=NUM))
    state = create_train_state(cfg, device="cpu")
    root = str(scratch)
    orbax_io.save_orbax(root, 4, orbax_io.train_state_tree(state, make_mesh(), epoch=0,
                                                            iteration=4))
    _mkdirs(root, [8], complete=False)
    shutil.copytree(os.path.join(root, "orbax_000000004"), os.path.join(root,
                                                                     "orbax_000000009.tmp"))
    assert orbax_io.latest_orbax_step(root) == 4
    assert orbax_io.load_orbax(root)["iter"] == 4
    assert orbax_io.prune_orbax(root, keep_every=0, keep_last=1) == 0
    assert sorted(os.listdir(root)) == ["orbax_000000004", "orbax_000000008",
                                        "orbax_000000009.tmp"]
    with pytest.raises(FileNotFoundError, match="no orbax checkpoints"):
        orbax_io.load_orbax(str(scratch / "orbax_000000008"))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("orbax"))
    torch.save({"num_classes": NUM, "feats": feats()}, os.path.join(out, "inputs.pt"))
    join_ranks(start_ranks("orbax", out, world=2))
    yield out, [torch.load(os.path.join(out, f"orbax.{r}.pt"), weights_only=False)
                for r in range(2)]
    shutil.rmtree(out, ignore_errors=True)


def _assert_state_equal(got, want):
    (sd, opt), (want_sd, want_opt) = got, want
    assert sd.keys() == want_sd.keys() and opt.keys() == want_opt.keys()
    for k, v in want_sd.items():
        assert torch.equal(sd[k], v), k
    for k, st in want_opt.items():
        assert st.keys() == opt[k].keys(), k
        for e, v in st.items():
            assert _equal(opt[k][e], v), (k, e)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), "one process"])
def test_saved_under_1x2_loads_under_any_mesh(two_ranks, shape):
    from torch_distributed_worker import _digest

    out, ranks = two_ranks
    saved = ranks[0]["saved"]
    assert saved[0]["classifier.weight"].shape == (NUM, 512)
    assert ranks[0]["saved_digest"] == ranks[1]["saved_digest"] == _digest(saved)
    if shape == "one process":
        sd, opt, meta = orbax_io.state_dicts_from_tree(orbax_io.load_orbax(
            os.path.join(out, "ck")))
        assert meta == {"epoch": 0, "iter": 1, "step": 1}
        _assert_state_equal((sd, opt), saved)
        return
    for r, res in enumerate(ranks):
        got = res[shape]
        assert got["meta"] == {"epoch": 0, "iter": 1, "step": 1} and got["step"] == 1
        assert got["digest"] == ranks[0]["saved_digest"], r  # the gathered state, to the bit
        if shape == (1, 2):  # the same shard as the one saved, padded row included
            assert got["offset"] == res["saved_shard"]["offset"] == 7 * r
            assert torch.equal(got["weight"], res["saved_shard"]["weight"])
        else:
            assert got["offset"] == 0
            assert torch.equal(got["weight"], saved[0]["classifier.weight"])


def test_the_classifier_is_written_in_shards(two_ranks):
    import torch.distributed.checkpoint as dcp

    path = os.path.join(two_ranks[0], "ck", "orbax_000000001")
    assert sorted(os.listdir(path)) == [".metadata", "__0_0.distcp", "__1_0.distcp"]
    md = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    for key in ("params/classifier.weight", "opt/classifier.weight/exp_avg",
                "opt/classifier.weight/exp_avg_sq"):
        chunks = sorted((tuple(c.offsets), tuple(c.sizes)) for c in md[key].chunks)
        assert tuple(md[key].size) == (NUM, 512)
        assert chunks == [((0, 0), (7, 512)), ((7, 0), (6, 512))], key
    # every replicated tensor written once
    tensors = {k: v for k, v in md.items() if hasattr(v, "chunks")}
    assert "model_state/Conv4Merge.0.norm.norm.running_mean" in tensors
    assert "opt/Conv4Merge.0.conv2d.weight/exp_avg" in tensors
    assert all(len(v.chunks) == 1 for k, v in tensors.items() if "classifier" not in k)


def test_padding_larger_than_a_shard(scratch):
    """5 classes over 4 shards of 2 rows: the last shard holds padding only
    and writes an empty chunk; the whole weight loads back."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((13, 512)).astype(np.float32)
    out = str(scratch)
    torch.save({"w": torch.from_numpy(w), "feat": torch.zeros(2, 512),
                "label": torch.tensor([0, 1]), "target": torch.zeros(2, 512), "s": 30.0,
                "m": 0.4}, os.path.join(out, "inputs.pt"))
    join_ranks(start_ranks("head", out, world=4))
    import torch.distributed.checkpoint as dcp

    md = dcp.FileSystemReader(os.path.join(out, "orbax_000000005")).read_metadata()
    chunks = sorted((tuple(c.offsets), tuple(c.sizes))
                    for c in md.state_dict_metadata["params/classifier.weight"].chunks)
    assert chunks == [((0, 0), (2, 512)), ((2, 0), (2, 512)), ((4, 0), (1, 512)),
                      ((5, 0), (0, 512))]
    back = orbax_io.load_orbax(out, 5)["params/classifier.weight"]
    assert torch.equal(back, torch.from_numpy(w[:5]))
