"""The driver's model axis and sharded checkpoints (python -m
ffrnet_torch.train --mesh_model M --ckpt_backend orbax) on the CPU, with
the one-conv stand-in for the frozen IR-SE50 of test_torch_driver.py.

  * one process, --ckpt_backend orbax (ffrnet_tpu's
    tests/test_driver.py:173-206): 8 steps with save_freq 4 save a DCP
    directory orbax_<step> at every 'latest' boundary, once a step, and
    keep the save_freq multiples and the newest two (4, 7, 8); no pth file
    is written; --continue_train 1 with total_epochs 2 resumes from the
    latest step and ends at 16, bit-equal to an uninterrupted 16-step run
  * two gloo ranks with --mesh_model 2 (one model group on a 1x2 mesh)
    over test_torch_driver_ddp.py's JPEG tree, with the LFW eval at step 4
    and the attention panel: both ranks log the same metrics and eval
    results, within 1e-5 of a one-process run; the pth checkpoint's
    classifier is gathered and unpadded to (num_classes, 512) and is
    within 2e-5 of the one-process run's after two updates (the JAX
    package's TP bound); with --ckpt_backend orbax every rank writes its
    class rows and the state agrees with the pth run's; a resume from
    step 2 under --mesh_model 2 is bit-equal to the uninterrupted run, for
    both stores
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from ffrnet_torch import train as train_mod
from ffrnet_torch.checkpoint.orbax_io import load_orbax, state_dicts_from_tree
from ffrnet_torch.checkpoint.store import load_checkpoint
from ffrnet_torch.config import Options
from test_torch_driver_ddp import argv, opts_of, run_ranks, tree  # noqa: F401 (a fixture)
from torch_distributed_worker import StandIn

torch.set_num_threads(1)

PARAM_ATOL = 2e-5


def orbax_opts(root, **kw):
    base = dict(phase="train", train_data="synthetic", num_classes=8, batch_size=4,
                total_epochs=1, optimizer="sgd", lr=1e-3, momentum=0.9, save_freq=4,
                print_freq=1000, eval_freq=0, n_thread=2, seed=0, ckpt_backend="orbax",
                weight_root=str(root), device="cpu")
    base.update(kw)
    return Options(**base).finalize()


def steps_in(ckpt_dir):
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir) if d.startswith("orbax_"))


def assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for k, v in b.items():
        assert (torch.equal(a[k], v) if isinstance(v, torch.Tensor) else a[k] == v), k


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """(the run of 8 steps, then resumed to 16; an uninterrupted 16-step
    run), the directories after the first run."""
    root = tmp_path_factory.mktemp("orbax_driver")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_mod, "load_encoder", lambda opts, device: StandIn().to(device).eval())
        opts = orbax_opts(root / "run")
        train_mod.train(opts)
        first = steps_in(opts.ckpt_dir), sorted(os.listdir(opts.ckpt_dir))
        train_mod.train(orbax_opts(root / "run", continue_train=1, total_epochs=2))
        whole = orbax_opts(root / "whole", total_epochs=2)
        train_mod.train(whole)
    yield opts, whole, first
    shutil.rmtree(root, ignore_errors=True)  # 2 GB of step directories


def test_orbax_cadence_and_pruning(one_process):
    opts, _, (steps, names) = one_process
    assert 8 in steps and 4 in steps
    assert all(s % 4 == 0 or s >= 7 for s in steps), steps  # the JAX test's assertion
    assert steps == [4, 7, 8]
    assert not [n for n in names if n.endswith(".pth.gzip") or n.endswith(".tmp")]
    assert load_orbax(opts.ckpt_dir, 8)["iter"] == 8


def test_orbax_resume_is_bit_equal_to_an_uninterrupted_run(one_process):
    opts, whole, _ = one_process
    assert steps_in(opts.ckpt_dir) == [4, 8, 12, 15, 16]
    assert steps_in(whole.ckpt_dir) == [4, 8, 12, 15, 16]
    got, want = load_orbax(opts.ckpt_dir), load_orbax(whole.ckpt_dir)
    assert (got["epoch"], got["iter"], got["step"]) == (1, 16, 16)
    assert any(k.endswith("momentum_buffer") for k in got)
    assert_trees_equal(got, want)


# ------------------------------------------------------ two ranks, M = 2


def scalars(opts, rank):
    sub = "" if rank == 0 else f"rank{rank}"
    with open(os.path.join(opts.log_dir, opts.save_weight_dir, sub, "all_scalars.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def model_axis(tree, tmp_path_factory):  # noqa: F811 (the fixture imported above)
    """Two ranks: --mesh_model 2 with the pth store (eval at 4, attention
    panel) and with --ckpt_backend orbax; then each resumed from step 2 in
    a fresh root. One process: the pth run."""
    root = str(tmp_path_factory.mktemp("mm"))
    mm = argv(tree, os.path.join(root, "mm"), "--mesh_model", "2", "--visualize", "1")
    mmo = argv(tree, os.path.join(root, "mmo"), "--mesh_model", "2", "--ckpt_backend", "orbax",
               "--eval_freq", "0")
    run_ranks(root, [mm, mmo])
    resume = argv(tree, os.path.join(root, "resume"), "--mesh_model", "2", "--continue_train",
                  "1", "--which_file", "0000002", "--eval_freq", "0")
    resume_o = argv(tree, os.path.join(root, "resume_o"), "--mesh_model", "2", "--ckpt_backend",
                    "orbax", "--continue_train", "1", "--which_file", "2", "--eval_freq", "0")
    shutil.copy(os.path.join(opts_of(mm).ckpt_dir, "0000002.pth.gzip"),
                train_mod.parse_args(resume).ckpt_dir)
    shutil.copytree(os.path.join(opts_of(mmo).ckpt_dir, "orbax_000000002"),
                    os.path.join(train_mod.parse_args(resume_o).ckpt_dir, "orbax_000000002"))
    run_ranks(root, [resume, resume_o])
    single = argv(tree, os.path.join(root, "single"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_mod, "load_encoder", lambda opts, device: StandIn().to(device).eval())
        train_mod.main(single)
    yield {k: opts_of(a) for k, a in (("mm", mm), ("mmo", mmo), ("resume", resume),
                                      ("resume_o", resume_o), ("single", single))}
    shutil.rmtree(root, ignore_errors=True)  # 1.4 GB of checkpoints


def test_model_axis_ranks_log_the_one_process_metrics(model_axis):
    mm, single = model_axis["mm"], model_axis["single"]
    s0, s1, ss = scalars(mm, 0), scalars(mm, 1), scalars(single, 0)
    loss = "train_values/TotalLoss"
    assert s0[loss]["iters"] == ss[loss]["iters"] == [1, 2, 3, 4]
    for tag in s0:  # averaged metrics, gathered eval results
        assert s0[tag] == s1[tag], tag
    for tag in ("train_values/TotalLoss", "train_values/ClassifierLoss"):
        np.testing.assert_allclose(s0[tag]["values"], ss[tag]["values"], rtol=1e-5, atol=1e-6)
    for ocl in range(3):
        tag = f"test_acc/ocl{ocl}/acc_new"
        assert s0[tag]["iters"] == [4] and s0[tag]["values"] == ss[tag]["values"], tag
    assert os.listdir(os.path.join(mm.ckpt_dir, "visuals")) == ["attention_0000004.png"]


def test_model_axis_checkpoints_match_one_process(model_axis):
    """After two updates: the gathered, unpadded pth classifier and every
    parameter within 2e-5 of one process; the orbax run's state equal to
    the pth run's."""
    got, opt, meta = load_checkpoint(model_axis["mm"].ckpt_dir, "0000002")
    want, want_opt, want_meta = load_checkpoint(model_axis["single"].ckpt_dir, "0000002")
    assert meta == want_meta == {"epoch": 0, "iter": 2}
    assert got["classifier.weight"].shape == (4, 512)
    assert opt.keys() == want_opt.keys()  # SGD at momentum 0: no state entries
    for k, v in want.items():
        if v.is_floating_point():
            torch.testing.assert_close(got[k], v, atol=PARAM_ATOL,
                                       rtol=1e-5 if "running" in k else 0.0, msg=k)
    assert (got["classifier.weight"] - want["classifier.weight"]).abs().max() < PARAM_ATOL
    sd_o, _, meta_o = state_dicts_from_tree(load_orbax(model_axis["mmo"].ckpt_dir, 2))
    assert meta_o == {"epoch": 0, "iter": 2, "step": 2}
    for k, v in got.items():
        assert torch.equal(sd_o[k], v), k
    names = sorted(os.listdir(os.path.join(model_axis["mmo"].ckpt_dir, "orbax_000000004")))
    assert names == [".metadata", "__0_0.distcp", "__1_0.distcp"]


def test_model_axis_resume_is_bit_equal(model_axis):
    sd, _, meta = load_checkpoint(model_axis["resume"].ckpt_dir, "0000004")
    want, _, want_meta = load_checkpoint(model_axis["mm"].ckpt_dir, "0000004")
    assert meta == want_meta == {"epoch": 1, "iter": 4}
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    assert_trees_equal(load_orbax(model_axis["resume_o"].ckpt_dir, 4),
                       load_orbax(model_axis["mmo"].ckpt_dir, 4))
