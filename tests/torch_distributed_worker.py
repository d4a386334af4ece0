"""One rank of the port's multi-process CPU tests (gloo). Not a test module:
the tests start it (`start_ranks`, or test_torch_driver_ddp.py's
`run_ranks`) as

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
  head    the class-sharded CosFace head and cross-entropy on 2 and 4
          shards of <dir>/inputs.pt's weight: logits, loss, argmax and
          gradients, and two controls (no model-group copy; each shard's
          softmax alone); then 5 classes over 4 shards saved by save_orbax
  tp      the jobs of <dir>/inputs.pt: distributed train steps over a
          ('data', 'model') mesh, each rank's metrics, checksums, shard and
          the gathered state
  orbax   one Adam step on a 1x2 mesh, save_orbax, then load_orbax under
          1x2 and 2x1
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


TIMEOUT = 600  # seconds a test waits for a rank


def start_ranks(mode, out, world=2):
    """`world` processes of this script in `mode` on a free port (called from
    a test; the ranks import no jax)."""
    import socket
    import subprocess

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(r), str(world),
                              str(port), out], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT) for r in range(world)]


def join_ranks(procs):
    """Wait for every rank; a rank that failed raises with its log's end."""
    for p in procs:
        log, _ = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, log.decode(errors="replace")[-4000:]


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


def _pad(w, rows):
    return torch.cat([w, w.new_zeros((rows - w.shape[0],) + w.shape[1:])])


def head(rank, world, port, out):
    """For M in (2, 4): model group of this rank (M=2: ranks {0, 1} and
    {2, 3}), its shard of the padded weight, and the loss
    cross_entropy + mse(feat, target), the mse a term that every model
    rank computes alike (its gradient must not be summed)."""
    from ffrnet_torch import parallel
    from ffrnet_torch.models.recnet import add_margin_logits
    from ffrnet_torch.parallel import class_shard, padded_num_classes
    from ffrnet_torch.parallel.collectives import copy_to_group
    from ffrnet_torch.training import losses

    inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    _join(rank, world, port)
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    num, label = inp["w"].shape[0], inp["label"]

    def local_softmax(logits, label, offset, group):  # the control: no all-reduce
        idx, own = losses._own(label, offset, logits.shape[1])
        true = torch.where(own, logits.gather(1, idx)[:, 0], torch.zeros(()))
        return torch.mean(torch.logsumexp(logits, dim=1) - true)

    res = {}
    for m, group in ((2, pairs[rank // 2]), (4, dist.group.WORLD)):
        off, rows = class_shard(num, m, rank % m)
        for variant in ("sharded", "no_copy", "local_softmax"):
            w = _pad(inp["w"], padded_num_classes(num, m))[off:off + rows].clone()
            w.requires_grad_(True)
            feat = inp["feat"].clone().requires_grad_(True)
            f = feat if variant == "no_copy" else copy_to_group(feat, group)
            logits, cosine = add_margin_logits(w, f, label, s=inp["s"], m=inp["m"],
                                               num_classes=num, offset=off)
            ce = (local_softmax if variant == "local_softmax" else
                  lambda *a: losses.cross_entropy(a[0], a[1], offset=a[2], group=a[3]))(
                      logits, label, off, group)
            loss = ce + losses.mse(feat, inp["target"])
            loss.backward()
            res[m, variant] = {
                "offset": off, "loss": loss.detach(), "ce": ce.detach(),
                "logits": logits.detach(), "cosine": cosine.detach(),
                "argmax": losses.argmax_classes(cosine, offset=off, group=group),
                "feat_grad": feat.grad, "w_grad": w.grad}
    # a padding of 3 rows, more than one shard's 2: 5 classes over 4 shards,
    # saved as class_rows_dtensor shards of a 1x4 mesh (the last shard empty)
    from ffrnet_torch.checkpoint.orbax_io import class_rows_dtensor, save_orbax

    off, rows = class_shard(5, 4, rank)
    w5 = _pad(inp["w"][:5], padded_num_classes(5, 4))[off:off + rows]
    save_orbax(out, 5, {"params/classifier.weight": class_rows_dtensor(
        w5, parallel.make_mesh(1, 4), 5, off)})
    torch.save(res, os.path.join(out, f"head.{rank}.pt"))
    dist.destroy_process_group()


def _digest(trees):
    """sha256 of a (state dict, {parameter key: optimizer state}) pair."""
    import hashlib

    sd, opt = trees
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].detach().contiguous().numpy().tobytes())
    for k in sorted(opt):
        for e in sorted(opt[k]):
            v = opt[k][e]
            h.update(f"{k}/{e}".encode())
            h.update(v.detach().contiguous().numpy().tobytes() if torch.is_tensor(v)
                     else repr(v).encode())
    return h.hexdigest()


def _replicated_checksum(model):
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        if k != "classifier.weight":
            h.update(k.encode())
            h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def tp(rank, world, port, out):
    """Each job of inputs.pt['jobs'] ({'name', 'kind': 'features' | 'images',
    'mesh': (D, M), 'cfg': TrainerConfig kwargs, 'num_classes', 'steps'})
    on a fresh state (inputs.pt['recnet'] with no optimizer state, or
    seed 1 where the job says 'seed'), its data coordinate's shard of each
    global batch."""
    from ffrnet_torch import parallel
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.models.recnet import RecNetConfig
    from ffrnet_torch.parallel.collectives import average_tensor
    from ffrnet_torch.training.trainer import (TrainerConfig, create_train_state,
                                               gather_train_state, load_train_state,
                                               make_distributed_feature_step,
                                               make_distributed_step)

    inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    _join(rank, world, port)
    res = {}
    for job in inp["jobs"]:
        mesh = parallel.make_mesh(*job["mesh"])
        d, _ = parallel.mesh_coordinate(mesh)
        n_data = job["mesh"][0]
        cfg = TrainerConfig(recnet=RecNetConfig(num_classes=job["num_classes"]), **job["cfg"])
        state = create_train_state(cfg, device="cpu")
        if "seed" not in job:
            load_train_state(state, inp["recnet"], {}, 0)
        if job["kind"] == "features":
            step, state = make_distributed_feature_step(mesh, cfg, state)
            calls = [lambda s, f=f: step(s, _shard(f, d, n_data)) for f in inp["feats"]]
        else:
            encoder = build_backbone()
            encoder.load_state_dict(inp["encoder"])
            encoder.eval()
            bound, (enc, state) = make_distributed_step(mesh, cfg, encoder, state)
            calls = [lambda s, b=b: bound(enc, s, _shard(b, d, n_data)) for b in inp["batches"]]
        metrics, sums = [], []
        for call in calls[:job["steps"]]:
            state, m = call(state)
            metrics.append({k: (v if k == "LR" else float(average_tensor(
                v.float(), dist.group.WORLD))) for k, v in m.items()})
            sums.append(_replicated_checksum(state.model))
        p = state.model.classifier.weight
        moments = {k: v.clone() for k, v in state.optimizer.inner.state.get(p, {}).items()
                   if isinstance(v, torch.Tensor) and v.shape == p.shape}
        trees = gather_train_state(state, parallel.model_group(mesh))
        res[job["name"]] = {"metrics": metrics, "checksums": sums, "shard": p.detach().clone(),
                            "offset": state.model.classifier.class_offset,
                            "moments": moments, "digest": _digest(trees),
                            "state": trees[0] if rank == 0 else None}
    torch.save(res, os.path.join(out, f"tp.{rank}.pt"))
    dist.destroy_process_group()


def orbax(rank, world, port, out):
    """One Adam step of make_distributed_feature_step on a 1x2 mesh (13
    classes), the gathered state, save_orbax; then load_orbax and bind
    under 1x2 and under 2x1."""
    from ffrnet_torch import parallel
    from ffrnet_torch.checkpoint.orbax_io import (load_orbax, save_orbax,
                                                  state_dicts_from_tree, train_state_tree)
    from ffrnet_torch.models.recnet import RecNetConfig
    from ffrnet_torch.training.trainer import (TrainerConfig, bind_to_mesh, create_train_state,
                                               gather_train_state, load_train_state,
                                               make_distributed_feature_step)

    inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    _join(rank, world, port)
    cfg = TrainerConfig(recnet=RecNetConfig(num_classes=inp["num_classes"]), optimizer="adam",
                        lr=1e-3)
    mesh = parallel.make_mesh(1, 2)
    state = create_train_state(cfg, device="cpu")
    step, state = make_distributed_feature_step(mesh, cfg, state)
    state, _ = step(state, inp["feats"])
    saved = gather_train_state(state, parallel.model_group(mesh))
    res = {"saved": saved if rank == 0 else None, "saved_digest": _digest(saved),
           "saved_shard": {"offset": state.model.classifier.class_offset,
                           "weight": state.model.classifier.weight.detach().clone()}}
    ck = os.path.join(out, "ck")
    if rank == 0:
        os.makedirs(ck, exist_ok=True)
    dist.barrier()
    save_orbax(ck, 1, train_state_tree(state, mesh, epoch=0, iteration=1))
    for shape in ((1, 2), (2, 1)):
        sd, opt, meta = state_dicts_from_tree(load_orbax(ck))
        fresh = load_train_state(create_train_state(cfg, device="cpu"), sd, opt, meta["iter"])
        m = parallel.make_mesh(*shape)
        bind_to_mesh(m, fresh)
        res[shape] = {"digest": _digest(gather_train_state(fresh, parallel.model_group(m))),
                      "weight": fresh.model.classifier.weight.detach().clone(),
                      "offset": fresh.model.classifier.class_offset, "meta": meta,
                      "step": fresh.step}
    torch.save(res, os.path.join(out, f"orbax.{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    mode, rank, world, port, out = sys.argv[1:6]
    {"steps": steps, "eval": evaluate, "driver": driver, "head": head, "tp": tp,
     "orbax": orbax}[mode](int(rank), int(world), int(port), out)
