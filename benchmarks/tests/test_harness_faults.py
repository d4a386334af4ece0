"""`correct` comes out false when the timed path is broken underneath:
each run here skips the look for a card, drives the rest of a run on the
CPU at a tiny size, and plants one fault in the program's call. And each
cell's control, the reference in the program's place at the next lower
precision, fails the cell's limits."""

import pytest
import torch

from benchmarks import harness
from benchmarks.tests.tiny import run_tiny, tiny_spec
from ffrnet_torch.api import FFRNet

EMBED_CELLS = ["embed-fused-bf16-n256", "embed-int8-bf16-n256"]


def _embed_fault(kind):
    real = FFRNet.embed
    last = {}

    def broken(self, images):
        raw, rect = real(self, images)
        if kind == "answer_altered":
            raw, rect = raw.clone(), rect.clone()
            raw[0], rect[0] = -raw[0], -rect[0]
        elif kind == "half_batch":
            h = raw.shape[0] // 2
            raw, rect = torch.cat([raw[:h], raw[:h]]), torch.cat([rect[:h], rect[:h]])
        elif kind == "state_unchanged":  # the previous call's answers
            prev = last.get("out", (raw, rect))
            last["out"] = (raw, rect)
            raw, rect = prev
        return raw, rect

    return broken


@pytest.mark.parametrize("cell", EMBED_CELLS)
@pytest.mark.parametrize("kind", ["answer_altered", "half_batch", "state_unchanged"])
def test_embed_faults(monkeypatch, cell, kind):
    monkeypatch.setattr(FFRNet, "embed", _embed_fault(kind))
    # set-up warms every pool batch through the same entry, so a stale
    # answer shows from the window's first call on
    result, _ = run_tiny(cell)
    assert not result["correct"] and result["failed"] >= 1


def _encoder_fault(kind):
    """system.encoder with one fault in the program's IR-SE50: a BN dropped
    (the identity in its place), a BN's mean and variance swapped, or every
    PReLU's slopes read from the wrong channels (reversed)."""
    from benchmarks import system

    real = system.encoder

    def broken(config, seed, device):
        enc = real(config, seed, device)
        bn = enc.body[5].res_layer[4]
        with torch.no_grad():
            if kind == "bn_dropped":
                bn.weight.fill_(1.0)
                bn.bias.zero_()
                bn.running_mean.zero_()
                bn.running_var.fill_(1.0)
            elif kind == "bn_mean_var_swapped":
                mean = bn.running_mean.clone()
                bn.running_mean.copy_(bn.running_var)
                bn.running_var.copy_(mean.abs())
            else:
                for m in enc.modules():
                    if isinstance(m, torch.nn.PReLU):
                        m.weight.copy_(m.weight.flip(0))
        return enc

    return broken


@pytest.mark.parametrize("cell,kind", [
    (cell, kind) for cell in EMBED_CELLS + ["ingest-fused-bf16-n256"]
    for kind in ("bn_dropped", "bn_mean_var_swapped", "prelu_channels_reversed")
    # one BN of 55 moves the int8 cell's embeddings by less than its 52
    # sites' rounding; its folds are held by test_int8_fold_ignoring_bn_bias
    if (cell, kind) != ("embed-int8-bf16-n256", "bn_dropped")])
def test_encoder_weight_faults(monkeypatch, cell, kind):
    """The encoder's BNs and per-channel slopes count: each fault moves the
    embeddings past the cell's limits."""
    from benchmarks import system

    monkeypatch.setattr(system, "encoder", _encoder_fault(kind))
    result, _ = run_tiny(cell)
    assert not result["correct"] and result["failed"] >= 1


def test_int8_fold_ignoring_bn_bias(monkeypatch):
    """BN folding that drops each BN's bias (the int8 configuration folds
    every conv -> BN pair) fails the int8 cell."""
    import ffrnet_torch.models.optimize as optimize

    def misfold(conv, bn):
        g = bn.weight / torch.sqrt(bn.running_var + optimize._EPS)
        conv.weight.copy_(conv.weight * g.reshape(-1, 1, 1, 1))
        conv.bias = torch.nn.Parameter(-bn.running_mean * g)
        optimize._identity(bn)

    monkeypatch.setattr(optimize, "_fold_conv", misfold)
    result, _ = run_tiny("embed-int8-bf16-n256")
    assert not result["correct"] and result["failed"] >= 1


@pytest.mark.parametrize("kind", ["crops_shifted", "answer_altered"])
def test_ingest_faults(monkeypatch, kind):
    import ffrnet_torch.api as api

    if kind == "crops_shifted":
        real = api.align_faces
        monkeypatch.setattr(api, "align_faces",
                            lambda *a, **kw: torch.roll(real(*a, **kw), 1, dims=2))
    else:
        real = FFRNet.embed_canvas

        def broken(self, canvas, landmarks, **kw):
            raw, rect, crops = real(self, canvas, landmarks, **kw)
            return raw, torch.flip(rect, dims=[0]), crops

        monkeypatch.setattr(FFRNet, "embed_canvas", broken)
    result, checks = run_tiny("ingest-fused-bf16-n256")
    assert not result["correct"]
    if kind == "crops_shifted":
        assert result["checks"]["crop_gap"]["value"] > result["checks"]["crop_gap"]["limit"]


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch", "loss_altered",
                                  "stale_after_setup"])
def test_train_faults(monkeypatch, kind):
    """A fault from the first step, or (stale_after_setup) one that starts
    only after set-up's steps, as a captured step that stops updating."""
    import ffrnet_torch.training.trainer as trainer

    real = trainer.train_step
    steps = []
    warm = tiny_spec("train-fused-fp32-n64").traffic["warm_steps"]

    def broken(encoder, state, batch, *, cfg, **kw):
        steps.append(1)
        if kind == "state_unchanged" or (kind == "stale_after_setup" and len(steps) > warm):
            # the update computed, then dropped
            params = list(state.model.parameters())
            saved = [p.detach().clone() for p in params]
            out = real(encoder, state, batch, cfg=cfg, **kw)
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
            return out
        if kind == "half_batch":
            h = batch["label"].shape[0] // 2
            return real(encoder, state, {k: v[:h] for k, v in batch.items()}, cfg=cfg, **kw)
        if kind == "loss_altered":
            state, metrics = real(encoder, state, batch, cfg=cfg, **kw)
            return state, dict(metrics, TotalLoss=metrics["TotalLoss"] * 1.01)
        return real(encoder, state, batch, cfg=cfg, **kw)

    monkeypatch.setattr(trainer, "train_step", broken)
    result, _ = run_tiny("train-fused-fp32-n64")
    assert not result["correct"]
    if kind == "stale_after_setup":
        window = result["checks"]["window_state_gap"]
        assert window["value"] > window["limit"]


@pytest.mark.parametrize("cell", EMBED_CELLS + ["ingest-fused-bf16-n256",
                                                 "train-fused-fp32-n64"])
def test_control_fails_the_limits(cell):
    """The control's readings at the tiny size, against the cell's limits
    (on the CPU TF32 does not exist, so the training cell's control is read
    by its faults there)."""
    spec = tiny_spec(cell)
    run = harness.Run(spec, 23, 1e9, False, device=torch.device("cpu"),
                      spans=harness.Spans(False))
    driver = harness.driver_class(spec.kind)(run)
    harness.run_window(run, driver, max_calls=2)
    driver.after_window()
    driver.release()
    readings = driver.controls()
    limits = spec.workload["limits"]
    for name, numbers in readings.items():
        if cell.startswith("train") and name == "control":
            continue
        assert any(numbers[k] > limits[k] for k in limits), (name, numbers)
