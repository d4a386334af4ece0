"""The port's bench_int8_convergence on the CPU at the smallest flags the
10-fold sweep takes (two steps with a checkpoint each, 4 classes, 10 pairs,
fp32): the JSON keys against the JAX tool's, the deltas recomputed from the
curves, the arm-consistent column on the int8 arm only, --out under
tmp_path, and a checkpoint's scoring leaving RecNet's running statistics
and mode as they were."""

import json

import pytest
import torch

from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.models.recnet import RecNetConfig
from ffrnet_torch.tools import bench_int8_convergence
from ffrnet_torch.tools.synth import make_eval_pairs
from ffrnet_torch.training.trainer import TrainerConfig, create_train_state

torch.set_num_threads(1)

TINY = ["--device", "cpu", "--dtype", "fp32", "--batch", "2", "--num_classes", "4",
        "--eval_pairs", "10", "--cal_images", "2"]
# ffrnet_tpu/tools/bench_int8_convergence.py:360-368 (curve), :372-378, :379-390
CONV_KEYS = {"tool", "config", "arms", "deltas_int8_minus_float", "wall_s"}
CURVE_KEYS = {"step", "TrainAcc", "TotalLoss", "eval_acc_rect", "eval_acc_raw"}


def _run(main, argv, capsys):
    out = main(argv)
    return out, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_convergence_cpu(tmp_path, capsys):
    path = tmp_path / "conv.json"
    out, printed = _run(bench_int8_convergence.main, TINY + [
        "--steps", "2", "--ckpt_every", "1", "--out", str(path)], capsys)
    assert printed == {k: out[k] for k in ("tool", "config", "deltas_int8_minus_float",
                                           "wall_s")}
    with open(path) as f:
        assert json.load(f) == out
    assert set(out) == CONV_KEYS and set(out["arms"]) == {"float", "int8_static"}
    fl, q = out["arms"]["float"], out["arms"]["int8_static"]
    assert [c["step"] for c in fl] == [c["step"] for c in q] == [1, 2]
    for c in fl:
        assert set(c) == CURVE_KEYS
    for c in q:
        assert set(c) == CURVE_KEYS | {"eval_acc_rect_armenc"}
        assert 0.0 <= c["eval_acc_rect_armenc"] <= 1.0
    for d, f_, i_ in zip(out["deltas_int8_minus_float"], fl, q):
        assert d == {"step": f_["step"],
                     "d_eval_rect": round(i_["eval_acc_rect"] - f_["eval_acc_rect"], 4),
                     "d_eval_raw": round(i_["eval_acc_raw"] - f_["eval_acc_raw"], 4),
                     "d_TrainAcc": round(i_["TrainAcc"] - f_["TrainAcc"], 4)}


def test_checkpoint_scoring_leaves_recnet_as_it_was():
    """eval_ckpt scores in eval mode (running statistics read, not moved)
    and hands RecNet back in train mode, also when the scoring raises."""
    cfg = TrainerConfig(recnet=RecNetConfig(num_classes=4))
    rec = create_train_state(cfg, seed=3, device="cpu").model
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, buf in rec.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    before = {k: v.clone() for k, v in rec.state_dict().items()}
    encoder = build_backbone(generator=torch.Generator().manual_seed(0))
    templates = torch.rand(4, 112, 112, 3, generator=g) * 2 - 1
    pairs = make_eval_pairs(templates, 1, 10, 4, 0.1)
    accs = bench_int8_convergence.eval_ckpt(rec, encoder, pairs)
    assert len(accs) == 2 and all(0.0 <= a <= 1.0 for a in accs)
    assert rec.training
    after = rec.state_dict()
    for k, v in before.items():
        assert torch.equal(v, after[k]), k
    img1, img2, lab = pairs
    with pytest.raises(ValueError):
        bench_int8_convergence.eval_ckpt(rec, encoder, (img1, img2[:4], lab))
    assert rec.training
