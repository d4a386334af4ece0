"""Train / test driver (ffrnet_tpu/train.py), on one card or data-parallel
over K (one process each).

    python -m ffrnet_torch.train --phase train --train_data <CASIA root> \\
        --train_img_list <list> --test_data <LFW root> --test_pair_list <pairs.txt> ...
    python -m ffrnet_torch.train --phase test --test_data <LFW root> ...
    torchrun --nproc_per_node K -m ffrnet_torch.train --phase train ...

The JAX package's flags (config.py) and cadence: the metrics of every
iteration; a 'latest' checkpoint every max(save_freq//10, 1) iterations
and a numbered one every save_freq; LFW eval at ocl 0, 1 and 2 every
eval_freq; the LR schedule per iteration; --continue_train 1 --which_file
<name> resumes at the stored epoch and iteration, inside the epoch;
--int8_encoder 1 runs the frozen encoder of the step (or of the feature-
cache build) in int8 with calibrated scales, and the eval in float. Runs on
the card unless --device cpu.

The step's metrics are 0-d tensors on the card: they are queued, and
fetched in one copy at each print, save, eval or preemption boundary,
where every queued TotalLoss is checked to be finite before anything is
written.

Under a launcher (torchrun, or FFRNET_DISTRIBUTED=1 with RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT) each rank joins the process group
(NCCL, gloo with --device cpu) and the ('data', 'model') mesh is the world,
K = D x M ranks (--mesh_model M, --mesh_data 0 or D): each data coordinate
loads its strided share of every global batch (the M ranks of a model group
the same share), the steps average their gradients and share RecNet's BN
statistics over the data axis, --mesh_model M > 1 shards the CosFace
classifier and its optimizer moments over the model axis (padded to a
multiple of M, ffrnet_tpu/train.py:385-424), the queued metrics are
averaged over the ranks once per fetch, rank 0 alone writes the pth
checkpoints (the classifier gathered over its model group and unpadded
first) and the feature cache (the others wait for it), every rank resumes
from the same checkpoint, and an LFW eval scores a contiguous slice of the
pairs per rank and gathers the scores. Ranks above 0 log under
<log_dir>/<run>/rank<r>. A preemption signal is per process: the others
then wait in their next collective.

--ckpt_backend orbax (ffrnet_tpu/train.py:565-596) writes sharded
torch.distributed.checkpoint directories orbax_<step> (checkpoint/
orbax_io.py; not readable by the JAX package) in place of the pth files:
every rank writes its part, a step that hits both cadences saves once,
and rank 0 then prunes to the save_freq multiples and the newest two.
--continue_train 1 --which_file latest|<step> resumes from them under any
mesh.
"""

from __future__ import annotations

import copy
import os
import sys
import time
import types
from typing import Optional

import numpy as np
import torch

from ffrnet_torch import parallel
from ffrnet_torch.api import resolve_device
from ffrnet_torch.checkpoint.pth_io import (encoder_state_dict, load_pth,
                                            recnet_state_dict)
from ffrnet_torch.checkpoint.orbax_io import (load_orbax, prune_orbax, save_orbax,
                                              state_dicts_from_tree, train_state_tree)
from ffrnet_torch.checkpoint.store import (load_checkpoint, optimizer_state,
                                           save_checkpoint)
from ffrnet_torch.config import Options, parse_args
from ffrnet_torch.data.datasets import CasiaPairs, LfwPairs, SyntheticPairs
from ffrnet_torch.data.pipeline import BatchLoader, SliceDataset
from ffrnet_torch.eval.runner import (evaluate_pairs, evaluate_pairs_multiprocess,
                                      make_pair_score_fn, process_pair_slice)
from ffrnet_torch.models.irse import build_backbone, check_state_dict
from ffrnet_torch.models.recnet import build_recnet
from ffrnet_torch.parallel.collectives import average_tensor
from ffrnet_torch.training.trainer import (FEATURE_PACK, bind_to_mesh, create_train_state,
                                           gather_train_state, half_dtype, load_train_state,
                                           train_step, train_step_from_features)
from ffrnet_torch.utils.logger import Logger
from ffrnet_torch.utils.timer import Timer


class PreemptionGuard:
    """SIGTERM/SIGUSR1 -> finish the step in flight, write 'latest', exit
    with a resume hint. The handler only sets a flag; the work happens at a
    safe point of the train loop (checkpoint writes are atomic anyway)."""

    def __init__(self):
        self.requested = False
        self._prev_handlers = {}

    def install(self) -> "PreemptionGuard":
        import signal

        for sig in (signal.SIGTERM, signal.SIGUSR1):
            self._prev_handlers[sig] = signal.signal(sig, self._handler)
        return self

    def uninstall(self) -> None:
        """Restore the handlers that were there before install(), so a
        signal after train() returns terminates as it would have."""
        import signal

        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):  # not the main thread / odd prev
                pass
        self._prev_handlers = {}

    def _handler(self, signum, frame):
        self.requested = True
        print(f"[preempt] signal {signum} received — will checkpoint and exit after the "
              "current step", file=sys.stderr, flush=True)


#: module-level so tests (and embedding applications) can trigger and inspect it
preemption_guard = PreemptionGuard()


def load_encoder(opts: Options, device) -> torch.nn.Module:
    """The frozen fp32 IR-SE50 in eval mode on `device`: from
    --encoder_weights when the file exists, else random (seed 0). On the
    card TF32 is switched off (process-wide, as FFRNet.prepare does): eval
    and the feature cache keep fp32 numerics."""
    device = torch.device(device)
    if opts.encoder_weights and os.path.exists(opts.encoder_weights):
        sd = encoder_state_dict(load_pth(opts.encoder_weights))
        check_state_dict(sd)
        enc = build_backbone()
        enc.load_state_dict(sd)
    else:
        print(f"[warn] encoder weights {opts.encoder_weights!r} not found — random init "
              "(parity numbers will be meaningless)", file=sys.stderr)
        enc = build_backbone(generator=torch.Generator().manual_seed(0))
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return enc.to(device).eval()


# the feature-cache fingerprint's tag of a build by the int8-static encoder
INT8_CACHE_TAG = "int8-static-v1"


def prepare_int8_encoder(encoder: torch.nn.Module, dataset, compute_dtype: str,
                         cal_images: int = 8) -> torch.nn.Module:
    """The int8-static frozen encoder of --int8_encoder 1
    (ffrnet_tpu/train.py:121-175): BN folded (exact: the frozen encoder
    runs in eval mode), cast to the compute type, int8 sites, and static
    scales calibrated on the first `cal_images` training images of both
    streams (mask-free and occluded), drawn with np.random.default_rng(0)
    so the loader's own streams are untouched. Gradients never reach the
    encoder, so the backward pass is unchanged. One eager pass on the
    encoder's device."""
    from ffrnet_torch.models.optimize import fold_backbone_bn
    from ffrnet_torch.models.quantize import calibrate_activation_scales, quantize_encoder

    half = half_dtype(compute_dtype)
    enc = fold_backbone_bn(encoder)
    if half is not None:
        enc = enc.to(half)
    imgs = []
    cal_rng = np.random.default_rng(0)
    for i in range(len(dataset)):
        item = dataset.get(i, cal_rng)
        for k in ("img_non", "img_ocl"):
            a = np.asarray(item[k])
            if a.dtype == np.uint8:  # host_normalize=0 samples
                a = a.astype(np.float32) / 127.5 - 1.0
            imgs.append(a.astype(np.float32))
        if len(imgs) >= cal_images:
            break
    w = enc.input_layer[0].weight
    x = torch.from_numpy(np.stack(imgs[:cal_images])).to(w.device, w.dtype)
    t0 = time.perf_counter()
    enc = calibrate_activation_scales(quantize_encoder(enc), [x.permute(0, 3, 1, 2).contiguous()])
    print(f"[int8_encoder] calibrated static scales on {len(x)} training images in "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
    return enc.eval()


def make_train_dataset(opts: Options):
    host_norm = bool(opts.host_normalize)
    if opts.train_data in ("", "synthetic"):
        print("[warn] no --train_data given — synthetic identity dataset", file=sys.stderr)
        return SyntheticPairs(num_identities=min(opts.num_classes, 64),
                              host_normalize=host_norm)
    img_list = opts.train_img_list or os.path.join(
        os.path.dirname(opts.train_data), "test", "casia_cleanlist.txt")
    return CasiaPairs(opts.train_data, img_list, host_normalize=host_norm)


def make_eval_batches(opts: Options, ocl_num: int, batch_size: int, device=None):
    """(the eval batches of one ocl level, the number of pairs). The
    reference's random eval flip is opt-in (--faithful_eval_flip 1); the
    loader uploads each batch to `device` in its producer thread. Over
    several processes, the batches of this process's contiguous
    process_pair_slice (the number is still that of the whole list)."""
    ds = LfwPairs(opts.test_data, opts.test_pair_list, test_ocl_num=ocl_num,
                  flip_prob=0.5 if opts.faithful_eval_flip else 0.0,
                  host_normalize=bool(opts.host_normalize))
    n_pairs = len(ds)
    if parallel.world_size() > 1:
        ds = SliceDataset(ds, process_pair_slice(n_pairs, parallel.rank(), parallel.world_size()))
    loader = BatchLoader(ds, batch_size, shuffle=False, drop_last=False, seed=opts.seed,
                         num_threads=opts.n_thread, device=device,
                         pack={"imgs": ("img1", "img2")} if opts.pack_upload else None)
    return loader.epoch(0), n_pairs


def eval_lfw(opts: Options, encoder, recnet, ocl_num: int, *,
             dump_wrong_to: Optional[str] = None, metrics_out: Optional[dict] = None):
    """(acc_new, acc) at one occlusion count, with the fp32 `encoder` and
    `recnet` in eval mode (a RecNet in train mode goes back to it after,
    also when the eval raises).

    dump_wrong_to: write each misclassified pair's images under
    <dump_wrong_to>/wrong_images{,_new}_ocl{n}/ (rank 0 alone over several
    processes). metrics_out: filled with the exact-ROC operating points
    {"new"/"raw": {"tar@far", "eer", "auc"}}.
    """
    from ffrnet_torch.eval.lfw import misclassified_indices, roc_metrics
    from ffrnet_torch.eval.runner import save_wrong_images

    if parallel.rank() != 0:
        dump_wrong_to = None
    was_training = recnet.training
    recnet.eval()
    try:
        device = encoder.input_layer[0].weight.device
        batches, n_pairs = make_eval_batches(opts, ocl_num, opts.batch_size, device=device)
        want_scores = dump_wrong_to is not None or metrics_out is not None
        score_fn = make_pair_score_fn(encoder, recnet)
        if parallel.world_size() > 1:
            out = evaluate_pairs_multiprocess(score_fn, batches, n_pairs=n_pairs,
                                              return_scores=want_scores)
        else:
            out = evaluate_pairs(score_fn, batches, return_scores=want_scores)
    finally:
        recnet.train(was_training)
    res_new, res_raw = out[:2]
    if want_scores:
        s_new, s_raw, labels = out[2:]
        if metrics_out is not None:
            metrics_out["new"] = roc_metrics(s_new, labels)
            metrics_out["raw"] = roc_metrics(s_raw, labels)
        if dump_wrong_to is not None:
            dump_ds = LfwPairs(opts.test_data, opts.test_pair_list, test_ocl_num=ocl_num,
                               flip_prob=0.0)
            for scores, res, sub in ((s_new, res_new, "wrong_images_new"),
                                     (s_raw, res_raw, "wrong_images")):
                wrong = misclassified_indices(scores, labels, res)
                n = save_wrong_images(dump_ds, wrong,
                                      os.path.join(dump_wrong_to, f"{sub}_ocl{ocl_num}"))
                print(f"[save_wrong] ocl{ocl_num} {sub}: {n} files", file=sys.stderr)
    return float(res_new.mean_accuracy), float(res_raw.mean_accuracy)


def log_attention_visual(opts: Options, encoder, recnet, logger, iteration: int) -> None:
    """Render and log the attention panel of the first ocl-1 eval batch
    (ffrnet_tpu/train.py:315-366; the reference's visualize(),
    lfw/lfw_eval.py:164-223, defined there but never called): clean|masked
    4-column panels (image, 67x67 M_space grid, M_channel matrix,
    argmax-channel feature map) to TensorBoard and
    ckpt_dir/visuals/attention_{iter:07d}.png.

    M_space and M_channel come from the RecNet called with a label in eval
    mode: the path that holds M_channel (the fused kernel keeps it on
    chip). A RecNet in train mode goes back to it after."""
    from ffrnet_torch.eval.visualize import visualize_pair
    from ffrnet_torch.ops.nn import images_to_unit_range

    n_rows = min(opts.batch_size, 8)
    device = encoder.input_layer[0].weight.device
    batches, _ = make_eval_batches(opts, 1, n_rows, device=device)
    batch = next(batches)
    batches.close()
    img1 = batch["imgs"][:, 0] if "imgs" in batch else batch["img1"]
    img2 = batch["imgs"][:, 1] if "imgs" in batch else batch["img2"]
    i1, i2 = images_to_unit_range(img1), images_to_unit_range(img2)
    was_training = recnet.training
    recnet.eval()
    try:
        with torch.inference_mode():
            both = torch.cat([i1, i2]).permute(0, 3, 1, 2).contiguous()
            fm, _ = encoder(both)
            lab = torch.zeros((both.shape[0],), dtype=torch.long, device=device)  # head unused
            out = recnet(fm, lab)
    finally:
        recnet.train(was_training)

    def host(t):
        return t.float().cpu().numpy()

    fm, m_space, m_channel = host(fm.permute(0, 2, 3, 1)), host(out.m_space), host(out.m_channel)
    i1, i2 = host(i1), host(i2)
    n = i1.shape[0]

    def half(sl):
        return types.SimpleNamespace(m_space=m_space[sl], m_channel=m_channel[sl])

    panel = visualize_pair(i1, half(slice(None, n)), i2, half(slice(n, None)), fm[:n], fm[n:],
                           n_rows=n_rows)
    logger.record_single_image(panel, "attention/ocl1")
    try:
        from PIL import Image

        Image.fromarray(panel).save(os.path.join(opts.ckpt_dir, "visuals",
                                                 f"attention_{iteration:07d}.png"))
    except Exception as e:  # noqa: BLE001 — the PNG dump is best effort; the panel is not
        print(f"[visualize] PNG dump failed: {e}", file=sys.stderr)


def train(opts: Options) -> None:
    # armed first: setup takes long enough for a grace-window signal to land
    guard = preemption_guard
    guard.requested = False
    try:
        guard.install()
    except ValueError:  # not the main thread
        pass
    try:
        _train(opts, guard)
    finally:
        guard.uninstall()


def _run_name(opts: Options) -> str:
    """The logger's run directory: ranks above 0 log beside rank 0's."""
    r = parallel.rank()
    return opts.save_weight_dir if r == 0 else os.path.join(opts.save_weight_dir, f"rank{r}")


def make_train_mesh(opts: Options):
    """The ('data', 'model') mesh of a training run over the whole world
    (ffrnet_tpu/train.py:423-424), validated with the JAX package's messages
    and the global batch checked against its data axis."""
    world = parallel.world_size()
    mesh = parallel.make_mesh(n_data=opts.mesh_data or None, n_model=opts.mesh_model)
    axes = parallel.mesh_axes(mesh)
    if axes["data"] * axes["model"] != world:
        raise ValueError(f"--mesh_data {opts.mesh_data} x --mesh_model {opts.mesh_model} uses "
                         f"{axes['data'] * axes['model']} of the {world} ranks: the mesh is the "
                         "process group")
    parallel.validate_batch_for_mesh(mesh, opts.batch_size)
    return mesh


def _train(opts: Options, guard: PreemptionGuard) -> None:
    mesh = make_train_mesh(opts)
    rank, world = parallel.rank(), parallel.world_size()
    logger = Logger(opts.log_dir, _run_name(opts), phase="train")
    timer = Timer()
    cfg = opts.trainer_config()
    device = resolve_device(opts.device)

    dataset = make_train_dataset(opts)
    encoder = load_encoder(opts, device)

    state = create_train_state(cfg, seed=opts.seed, device=device)
    start_epoch, start_iter = 0, 0
    orbax = opts.ckpt_backend == "orbax"
    if opts.continue_train:
        if orbax:  # whole tensors on every rank; bind_to_mesh shards them below
            sd, opt, meta = state_dicts_from_tree(load_orbax(
                opts.ckpt_dir, None if opts.which_file == "latest" else int(opts.which_file),
                process_group=parallel.host_group()))
        else:
            sd, opt, meta = load_checkpoint(opts.ckpt_dir, opts.which_file)
        opt_sd = {} if opt is None else optimizer_state(opt, cfg.optimizer, state.model,
                                                        meta["iter"])
        load_train_state(state, sd, opt_sd, meta["iter"])
        start_epoch, start_iter = meta["epoch"], meta["iter"]
    elif opts.recnet_weights:
        state.model.load_state_dict(recnet_state_dict(load_pth(opts.recnet_weights),
                                                      cfg.recnet))
    # the data and model groups (None for an axis of one rank); the
    # classifier is padded and sharded over the model axis
    group, mgroup = bind_to_mesh(mesh, state)
    data_index = parallel.mesh_coordinate(mesh)[0]
    n_data = parallel.mesh_axes(mesh)["data"]

    if opts.cache_features:
        # the frozen encoder runs once over every (sample, flip); the steps
        # are RecNet-only, and the fp32 encoder stays for the LFW eval
        from ffrnet_torch.training.feature_cache import (CachedFeatureDataset,
                                                         build_feature_cache, to_nchw)

        cache_dir = opts.feature_cache_dir or os.path.join(opts.ckpt_dir, "feature_cache")
        flip_prob = getattr(dataset, "flip_prob", 0.0)
        flipfree = dataset
        if flip_prob:  # shares the parsed items; __post_init__ does not run again
            flipfree = copy.copy(dataset)
            flipfree.flip_prob = 0.0
        if not isinstance(dataset, CasiaPairs):
            print("[warn] --cache_features with a non-CasiaPairs dataset: the cache "
                  "freezes any per-epoch augmentation beyond the paired flip (e.g. "
                  "SyntheticPairs noise is drawn once)", file=sys.stderr)
        # --int8_encoder 1: the build's one encoder pass runs int8-static
        # (made only when a build is needed); the fingerprint hashes the
        # float encoder plus the variant tag, so int8-built and float-built
        # caches never collide
        factory = ((lambda: prepare_int8_encoder(encoder, flipfree, cfg.compute_dtype))
                   if opts.int8_encoder else None)
        build_kw = dict(batch_size=opts.batch_size, compute_dtype=cfg.compute_dtype,
                        num_threads=opts.n_thread, encoder_factory=factory,
                        fingerprint_extra=INT8_CACHE_TAG if opts.int8_encoder else "")
        if world > 1:  # rank 0 builds into the shared dir; the others wait for it
            from ffrnet_torch.training.feature_cache import build_feature_cache_shared

            build_feature_cache_shared(flipfree, encoder, cache_dir, process_index=rank,
                                       group=parallel.host_group(), **build_kw)
        else:
            build_feature_cache(flipfree, encoder, cache_dir, **build_kw)
        dataset = CachedFeatureDataset(cache_dir, flip_prob=flip_prob)
        if opts.int8_encoder:
            print("[info] feature cache built with the int8-static encoder (its quantization "
                  "error is in the cached features of every epoch); LFW eval stays float",
                  file=sys.stderr)
        pack = FEATURE_PACK if opts.pack_upload else None

        def step(batch):
            return train_step_from_features(state, to_nchw(batch), cfg=cfg, group=group,
                                            model_group=mgroup)
    else:
        half = half_dtype(cfg.compute_dtype)
        if opts.int8_encoder:  # the step's frozen forward runs int8; eval keeps `encoder`
            step_encoder = prepare_int8_encoder(encoder, dataset, cfg.compute_dtype)
        else:
            step_encoder = encoder if half is None else copy.deepcopy(encoder).to(half)
        pack = {"imgs": ("img_non", "img_ocl")} if opts.pack_upload else None

        def step(batch):
            return train_step(step_encoder, state, batch, cfg=cfg, group=group,
                              model_group=mgroup)

    last_orbax_step = [-1]

    def save_now(name: str, epoch: int, iteration: int) -> None:
        if orbax:  # every rank writes its part; one directory per step
            if iteration != last_orbax_step[0]:  # not when both cadences hit this step
                save_orbax(opts.ckpt_dir, iteration,
                           train_state_tree(state, mesh, epoch=epoch, iteration=iteration),
                           process_group=parallel.host_group())
                if rank == 0:  # after save_orbax's closing barrier
                    prune_orbax(opts.ckpt_dir, keep_every=opts.save_freq)
                last_orbax_step[0] = iteration
        elif data_index == 0:  # its model group gathers the classifier for rank 0
            sd, opt = gather_train_state(state, mgroup)
            if rank == 0:  # one writer of the shared pth store
                save_checkpoint(opts.ckpt_dir, name, model=sd, optimizer=opt, epoch=epoch,
                                iteration=iteration)
        timer.update_time("Save")  # the write stays out of the next DataTime

    loader = BatchLoader(dataset, opts.batch_size, shuffle=not opts.debug,
                         drop_last=not opts.debug, seed=opts.seed,
                         num_threads=opts.n_thread, device=device, pack=pack,
                         process_index=data_index, process_count=n_data)

    logger.record_text("model_config", opts.config_string)
    cur_iters = start_iter
    total_iters = opts.total_epochs * len(loader)

    # Each step's metrics are 0-d device tensors: fetched in one copy at the
    # next print/save/eval/preemption boundary, not one sync per step
    pending: list = []

    def flush_metrics() -> None:
        """Fetch and log the queued metrics, and raise on a non-finite
        TotalLoss: this runs before every checkpoint write, so a poisoned
        step never reaches a checkpoint. Over several ranks the metrics are
        averaged in one collective (each is a mean over an equal shard), at
        the same iterations on every rank (over all of them: the ranks of a
        model group hold equal metrics, so every rank logs the same values)."""
        if not pending:
            return
        keys = [k for k in pending[0][2] if k != "LR"]
        stacked = torch.stack([torch.stack([m[k].detach().float() for k in keys])
                               for _, _, m in pending])
        if world > 1:
            stacked = average_tensor(stacked, torch.distributed.group.WORLD)
        fetched = stacked.cpu().tolist()
        queued, pending[:] = list(pending), []
        for (it, ep, m), row in zip(queued, fetched):
            logger.set_current_iter(it, ep)
            values = dict(zip(keys, row))
            values["LR"] = float(m["LR"])
            logger.record_scalar(values, "train_values")
            logger.print_scalar({k: f"{v:.4f}" for k, v in values.items() if k != "LR"})
            logger.print_scalar({"LR": f"{values['LR']:.6f}"})
            if not np.isfinite(values["TotalLoss"]):
                logger.close()
                raise FloatingPointError(
                    f"non-finite loss at iter {it} (epoch {ep}); restart with "
                    "--continue_train 1 --which_file latest")
        timer.update_time("Flush")  # the fetch stays out of the next DataTime

    # In-epoch resume: checkpoints store the GLOBAL iteration; the batches
    # already taken in the resume epoch are start_iter - start_epoch *
    # len(loader) (the reference compares the in-epoch index with the
    # global count, which skips the whole resume epoch). The loader skips
    # them without decoding, and its per-sample RNG keeps the rest as they
    # were.
    skip_in_epoch = min(max(start_iter - start_epoch * len(loader), 0), len(loader))

    for epoch in range(start_epoch, opts.total_epochs):
        start_b = skip_in_epoch if epoch == start_epoch else 0
        for batch in loader.epoch(epoch, start_batch=start_b):
            cur_iters += 1
            timer.update_time("DataTime")

            _, metrics = step(batch)
            timer.update_time("Step")
            pending.append((cur_iters, epoch, metrics))

            if cur_iters % opts.print_freq == 0:
                flush_metrics()
                print(f"Model Configuration: {opts.save_weight_dir}")
                logger.print_iter_summary(total_iters, opts.total_epochs, timer)

            if cur_iters % opts.save_freq == 0:
                flush_metrics()
                save_now("debug" if opts.debug else f"{cur_iters:07d}", epoch, cur_iters)
            if cur_iters % max(opts.save_freq // 10, 1) == 0:
                flush_metrics()
                save_now("latest", epoch, cur_iters)

            if guard.requested:
                flush_metrics()
                save_now("latest", epoch, cur_iters)
                print(f"[preempt] checkpointed at iter {cur_iters} (epoch {epoch}); resume "
                      "with --continue_train 1 --which_file latest", file=sys.stderr,
                      flush=True)
                logger.close()
                return

            if opts.eval_freq and cur_iters % opts.eval_freq == 0 and opts.test_data:
                flush_metrics()
                for ocl in range(1 if opts.debug else 3):
                    acc_new, acc = eval_lfw(opts, encoder, state.model, ocl)
                    logger.record_scalar({"acc": acc}, f"test_acc/ocl{ocl}")
                    logger.record_scalar({"acc_new": acc_new}, f"test_acc/ocl{ocl}")
                    print(f"test result ocl{ocl}: acc_new {acc_new:.4f} acc {acc:.4f}")
                if opts.visualize and rank == 0:
                    log_attention_visual(opts, encoder, state.model, logger, cur_iters)
                timer.update_time("Eval")
            if opts.debug:
                break
    flush_metrics()
    logger.close()


def test(opts: Options) -> None:
    logger = Logger(opts.log_dir, _run_name(opts), phase="test")
    cfg = opts.trainer_config()
    device = resolve_device(opts.device)
    encoder = load_encoder(opts, device)
    if opts.recnet_weights:
        sd = recnet_state_dict(load_pth(opts.recnet_weights), cfg.recnet)
    else:
        sd, _, _ = load_checkpoint(opts.ckpt_dir, opts.which_file)
    recnet = build_recnet(cfg.recnet)
    recnet.load_state_dict(sd)
    recnet = recnet.to(device).eval()
    logger.set_current_iter(0, 0)
    dump_dir = opts.ckpt_dir if opts.save_wrong else None
    for ocl in range(3):
        metrics = {} if opts.report_roc else None
        acc_new, acc = eval_lfw(opts, encoder, recnet, ocl, dump_wrong_to=dump_dir,
                                metrics_out=metrics)
        logger.record_scalar({"acc": acc}, f"test_acc/ocl{ocl}")
        logger.record_scalar({"acc_new": acc_new}, f"test_acc_new/ocl{ocl}")
        print(f"test result ocl{ocl}: acc_new {acc_new:.4f} acc {acc:.4f}")
        if metrics:
            for kind in ("new", "raw"):
                m = metrics[kind]
                logger.record_scalar(
                    {"eer": m["eer"], "auc": m["auc"],
                     **{f"tar@far{f:g}": t for f, t in m["tar@far"].items()}},
                    f"test_roc_{kind}/ocl{ocl}")
                tars = " ".join(f"tar@{f:g} {t:.4f}" for f, t in sorted(m["tar@far"].items()))
                print(f"test roc ocl{ocl} [{kind}]: eer {m['eer']:.4f} auc {m['auc']:.4f} "
                      f"{tars}")
    logger.close()


def main(argv=None):
    opts = parse_args(argv)
    np.random.seed(opts.seed)
    joined = not torch.distributed.is_initialized()
    dev = parallel.maybe_init_distributed(opts.device)
    if dev is not None:
        opts.device = str(dev)
    try:
        if opts.phase == "train":
            train(opts)
        else:
            test(opts)
    finally:
        if dev is not None and joined:
            parallel.shutdown_distributed()


if __name__ == "__main__":
    main()
