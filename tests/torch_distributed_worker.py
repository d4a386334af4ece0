"""One rank of the port's multi-process CPU tests (gloo). Not a test module:
tests/test_torch_ddp_vs_jax.py and tests/test_torch_driver_ddp.py start it
as

    python tests/torch_distributed_worker.py <mode> <rank> <world> <port> <dir>

and read what it writes into <dir>. It imports torch and ffrnet_torch,
never jax. Modes:

  steps   the distributed train_step and train_step_from_features for two
          updates each on this rank's shard of the global batches of
          <dir>/inputs.pt (images; NCHW features), then the
          same with per-rank BN statistics (the control), the averaged
          metrics, the int8 encoder's calibrated scales, and one train-mode
          BN's gradients over the group
  eval    evaluate_pairs_multiprocess over this rank's slice of the scores
          in <dir>/inputs.pt, and once more with rank 1 mis-sliced
  driver  ffrnet_torch.train.main for each argv of <dir>/driver.json, the
          frozen encoder a one-conv stand-in; records each call of
          save_checkpoint and build_feature_cache
"""

import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)


def _join(rank, world, port):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)


def _shard(batch, rank, world):
    n = len(batch["label"]) // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def _checksum(model):
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def steps(rank, world, port, out):
    from ffrnet_torch import parallel
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.models.recnet import RecNetConfig
    from ffrnet_torch.parallel.collectives import average_tensor
    from ffrnet_torch.training import trainer
    from ffrnet_torch.training.trainer import (TrainerConfig, create_train_state,
                                               load_train_state, make_distributed_feature_step,
                                               make_distributed_step)

    inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    _join(rank, world, port)
    mesh = parallel.make_mesh()
    group = parallel.data_group(mesh)
    cfg = TrainerConfig(recnet=RecNetConfig(num_classes=inp["num_classes"]), **inp["optimizer"])
    encoder = build_backbone()
    encoder.load_state_dict(inp["encoder"])
    encoder.eval()

    def fresh():
        st = create_train_state(cfg, device="cpu")
        return load_train_state(st, inp["recnet"], inp["opt"], 0)

    def run(kind):
        state = fresh()
        if kind == "features":
            step, state = make_distributed_feature_step(mesh, cfg, state)
            calls = [lambda s, f=f: step(s, _shard(f, rank, world)) for f in inp["feats"]]
        else:
            step, (enc, state) = make_distributed_step(mesh, cfg, encoder, state)
            calls = [lambda s, b=b: step(enc, s, _shard(b, rank, world)) for b in inp["batches"]]
        metrics, sums = [], []
        for call in calls:
            state, m = call(state)
            metrics.append({k: (v if k == "LR" else float(average_tensor(v.float(), group)))
                            for k, v in m.items()})
            sums.append(_checksum(state.model))
        return {"state": {k: v.clone() for k, v in state.model.state_dict().items()},
                "metrics": metrics, "checksums": sums}

    res = {"images": run("images"), "features": run("features"), "bn": bn_grads(inp["bn"], rank,
                                                                                  world, group)}
    # the control: the same steps with each rank's BNs on its own shard's
    # statistics (gradients still averaged), as a DDP without SyncBatchNorm
    real = trainer.batch_stats_group
    trainer.batch_stats_group = lambda group: contextlib.nullcontext()
    try:
        res["per_rank_bn"] = run("images")
    finally:
        trainer.batch_stats_group = real
    # --int8_encoder 1 under a mesh: every rank calibrates on the same images
    from ffrnet_torch.data.datasets import SyntheticPairs
    from ffrnet_torch.models.quantize import quantized_sites
    from ffrnet_torch.train import prepare_int8_encoder

    ds = SyntheticPairs(num_identities=2, host_normalize=False)
    q = prepare_int8_encoder(encoder, ds, "fp32")
    res["int8_scales"] = {name: site.x_scale.clone() for name, site in quantized_sites(q)}
    torch.save(res, os.path.join(out, f"steps.{rank}.pt"))
    dist.destroy_process_group()


def bn_grads(bn, rank, world, group):
    """Train-mode BN over the group on this rank's shard of bn['x'] (NCHW),
    the loss sum(y^2 * w) over the shard -> the new running stats and the
    gradients of x's shard, scale and bias."""
    from ffrnet_torch.ops.nn import batch_norm_train

    x = _shard({"x": bn["x"], "w": bn["w"], "label": bn["x"]}, rank, world)
    xl = x["x"].clone().requires_grad_(True)
    scale, bias = (bn[k].clone().requires_grad_(True) for k in ("scale", "bias"))
    c = scale.shape[0]
    y, mean, var = batch_norm_train(xl, scale, bias, torch.zeros(c), torch.ones(c), group=group)
    (y.square() * x["w"]).sum().backward()
    return {"x": xl.grad, "scale": scale.grad, "bias": bias.grad, "mean": mean, "var": var}


def evaluate(rank, world, port, out):
    from ffrnet_torch.eval.runner import evaluate_pairs_multiprocess, process_pair_slice

    inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    _join(rank, world, port)
    raw, new, lab = inp["raw"], inp["new"], inp["label"]
    n = len(lab)

    def batches(sl, size=64):
        idx = np.arange(n)[sl]
        for s in range(0, len(idx), size):
            i = idx[s:s + size]
            yield {"img1": raw[i], "img2": new[i], "label": lab[i]}

    def score(a, b):  # the batches carry the scores themselves
        return torch.as_tensor(a), torch.as_tensor(b)

    sl = process_pair_slice(n, rank, world)
    res = {"folds": [tuple(t.numpy() for t in r) for r in
                     evaluate_pairs_multiprocess(score, batches(sl), n_pairs=n)]}
    short = slice(sl.start, sl.stop - 1) if rank == 1 else sl  # rank 1 drops a pair
    try:
        evaluate_pairs_multiprocess(score, batches(short), n_pairs=n)
        res["mis_sliced"] = None
    except ValueError as e:
        res["mis_sliced"] = str(e)
    torch.save(res, os.path.join(out, f"eval.{rank}.pt"))
    dist.destroy_process_group()


class StandIn(torch.nn.Module):
    """tests/test_torch_driver.py's stand-in for the frozen IR-SE50: one
    16x16/16 convolution to the (N, 512, 7, 7) map and its normalized mean."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.input_layer = torch.nn.Sequential(torch.nn.Conv2d(3, 512, 16, stride=16))
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)

    def forward(self, x):
        fm = self.input_layer(x)
        return fm, torch.nn.functional.normalize(fm.mean((2, 3)), dim=1)


def driver(rank, world, port, out):
    from ffrnet_torch import train as T
    from ffrnet_torch.training import feature_cache as FC

    with open(os.path.join(out, "driver.json")) as f:
        runs = json.load(f)
    T.load_encoder = lambda opts, device: StandIn().to(device).eval()
    calls = {"save_checkpoint": [], "build_feature_cache": []}
    for mod, name in ((T, "save_checkpoint"), (FC, "build_feature_cache")):
        real = getattr(mod, name)

        def record(*a, _real=real, _name=name, **k):
            calls[_name].append(a[1] if _name == "save_checkpoint" else a[2])
            return _real(*a, **k)

        setattr(mod, name, record)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1")
    for i, argv in enumerate(runs["argvs"]):
        os.environ["MASTER_PORT"] = str(runs["ports"][i])
        T.main(argv)
        if dist.is_initialized():
            raise AssertionError("train.main left its process group joined")
    with open(os.path.join(out, f"driver.{rank}.json"), "w") as f:
        json.dump(calls, f)


if __name__ == "__main__":
    mode, rank, world, port, out = sys.argv[1:6]
    {"steps": steps, "eval": evaluate, "driver": driver}[mode](int(rank), int(world), int(port),
                                                               out)
