"""Experiment configuration: the JAX package's flag surface
(ffrnet_tpu/config.py) for the port's driver.

`Options` has every field of the JAX package's, with the same defaults and
derived paths (save_weight_dir, ckpt_dir, log_dir, opt.txt), plus
`device` (--device, default cuda), the port's explicit device. Every flag
is ported; a value the port cannot honour raises a ValueError, and none is
ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

from ffrnet_torch.models.recnet import SS_KERNEL_CONFIG, RecNetConfig
from ffrnet_torch.training.trainer import TrainerConfig

# --ss_impl -> the port's RecNet configuration: the JAX package's XLA
# default is the plain Grams (and the fused channel kernel in eval); its
# Pallas kernel is the self-similarity kernel configuration
_RECNET = {"xla": RecNetConfig(), "pallas": SS_KERNEL_CONFIG, "kernel": SS_KERNEL_CONFIG}


@dataclass
class Options:
    # phase / debug
    phase: str = "train"
    debug: int = 0
    # data
    dataset: str = "CASIA"
    train_data: str = ""
    train_img_list: str = ""
    val_data: str = ""
    test_data: str = ""           # LFW root (aligned + masked twins)
    test_pair_list: str = ""      # lfw_pairs.txt
    weight_root: str = "./weight"
    # model
    model_name: str = "FFR-Net"
    num_classes: int = 10575
    ss_impl: str = "xla"          # xla: plain Grams; pallas (or kernel): the kernel
    compute_dtype: str = "fp32"   # fp32 | bf16 (mixed-precision training)
    remat: int = 0                # recompute the RecNet branches in backward
    # loss
    loss_weight: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    loss: str = "sphere"
    faithful_ce_weight: int = 1
    # 1 replicates the reference's random paired flip of eval pairs, which
    # makes the reported accuracy seed-dependent; 0 = deterministic eval
    faithful_eval_flip: int = 0
    # optimizer
    optimizer: str = "Adam"
    lr: float = 1e-2
    beta1: float = 0.5
    beta2: float = 0.999
    weight_decay: float = 5e-4
    momentum: float = 0.9
    nesterov: int = 0
    # 1: encode every (sample, flip) through the frozen encoder once
    # (training/feature_cache.py), then train RecNet-only steps; exact for
    # datasets whose only augmentation is the paired flip (CASIA); the
    # cache lives in --feature_cache_dir (default <ckpt_dir>/feature_cache)
    cache_features: int = 0
    feature_cache_dir: str = ""
    # 1: both image (or feature) streams of a batch in one (N, 2, ...) upload
    pack_upload: int = 0
    # 0: uint8 pixels cross to the card and are normalized there (the same
    # values, a quarter of the bytes); 1: float32 [-1, 1] from the host
    host_normalize: int = 0
    # 1: the frozen encoder in the step (or the feature-cache build) runs
    # int8 with static scales calibrated on 8 training images; LFW eval
    # keeps the float encoder (train.py::prepare_int8_encoder)
    int8_encoder: int = 0
    # train
    seed: int = 123
    n_thread: int = 8
    batch_size: int = 64
    total_epochs: int = 10
    continue_train: int = 0
    ckpt_backend: str = "pth"     # pth: the .pth.gzip store; orbax: DCP step dirs orbax_<step>
    save_freq: int = 2000
    print_freq: int = 10
    eval_freq: int = 100
    report_roc: int = 0           # test phase: also the exact-ROC operating points
    visualize: int = 0            # log the attention panel at each eval (train.py)
    # parallelism: mesh_data x mesh_model is the process group (mesh_data 0:
    # world size // mesh_model); mesh_model shards the CosFace head's classes
    mesh_data: int = 0
    mesh_model: int = 1
    # test / misc
    test_result_dir: str = "./test_result"
    save_wrong: int = 0           # test phase: dump misclassified pairs under ckpt_dir
    which_file: str = "latest"
    other: str = ""
    encoder_weights: str = "./pretrain/se50.pth"
    recnet_weights: str = ""      # optional FFRNet.pth(.gzip) import
    device: str = "cuda"          # the port's device; cpu runs the plain twins

    # derived (filled by finalize)
    save_weight_dir: str = ""
    ckpt_dir: str = ""
    log_dir: str = ""
    config_string: str = ""

    def check_ported(self) -> None:
        """Raise ValueError for a flag value the port cannot honour."""
        if self.ss_impl not in _RECNET:
            raise ValueError(f"--ss_impl must be one of {sorted(_RECNET)}, got "
                             f"{self.ss_impl!r}")

    def finalize(self, make_dirs: bool = True) -> "Options":
        self.check_ported()
        self.save_weight_dir = "model_{}-loss_{}-{}".format(self.model_name, self.loss,
                                                            self.other)
        self.ckpt_dir = os.path.join(self.weight_root, self.save_weight_dir)
        self.log_dir = os.path.join(self.weight_root, "log_dir")
        if make_dirs:
            for d in (self.ckpt_dir, self.log_dir, os.path.join(self.ckpt_dir, "visuals"),
                      os.path.join(self.ckpt_dir, "test"), os.path.join(self.ckpt_dir, "val")):
                os.makedirs(d, exist_ok=True)
        lines = ["------------ Options -------------"]
        for f_ in sorted(dataclasses.fields(self), key=lambda f_: f_.name):
            lines.append(f"{f_.name}: {getattr(self, f_.name)}")
        lines.append("-------------- End ----------------")
        self.config_string = "\n".join(lines)
        if make_dirs:
            with open(os.path.join(self.ckpt_dir, "opt.txt"), "w") as fh:
                fh.write(self.config_string + "\n")
        return self

    def trainer_config(self) -> TrainerConfig:
        return TrainerConfig(
            optimizer=self.optimizer.lower(),
            lr=self.lr,
            beta1=self.beta1,
            beta2=self.beta2,
            momentum=self.momentum,
            weight_decay=self.weight_decay,
            nesterov=bool(self.nesterov),
            loss_weight=tuple(self.loss_weight),
            faithful_ce_weight=bool(self.faithful_ce_weight),
            compute_dtype=self.compute_dtype,
            remat=bool(self.remat),
            recnet=replace(_RECNET[self.ss_impl], num_classes=self.num_classes),
        )


def parse_args(argv: Optional[List[str]] = None, *, make_dirs: bool = True) -> Options:
    """argparse front-end: the JAX package's flags, and --device."""
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    d = Options()
    for name, kind in (("phase", str), ("debug", int), ("dataset", str),
                       ("train_data", str), ("train_img_list", str), ("val_data", str),
                       ("test_data", str), ("test_pair_list", str), ("weight_root", str),
                       ("model_name", str), ("num_classes", int), ("ss_impl", str)):
        p.add_argument(f"--{name}", type=kind, default=getattr(d, name))
    p.add_argument("--compute_dtype", type=str, default=d.compute_dtype,
                   choices=["fp32", "bf16"])
    p.add_argument("--remat", type=int, default=d.remat)
    p.add_argument("--loss_weight", type=float, nargs=4, default=list(d.loss_weight))
    for name, kind in (("loss", str), ("faithful_ce_weight", int),
                       ("faithful_eval_flip", int), ("host_normalize", int),
                       ("int8_encoder", int), ("cache_features", int), ("pack_upload", int),
                       ("feature_cache_dir", str), ("optimizer", str), ("lr", float),
                       ("beta1", float), ("beta2", float), ("weight_decay", float),
                       ("momentum", float), ("nesterov", int), ("seed", int)):
        p.add_argument(f"--{name}", type=kind, default=getattr(d, name))
    p.add_argument("--nThread", dest="n_thread", type=int, default=d.n_thread)
    for name, kind in (("batch_size", int), ("total_epochs", int), ("continue_train", int)):
        p.add_argument(f"--{name}", type=kind, default=getattr(d, name))
    p.add_argument("--ckpt_backend", type=str, default=d.ckpt_backend,
                   choices=["pth", "orbax"])
    for name, kind in (("save_freq", int), ("print_freq", int), ("eval_freq", int),
                       ("report_roc", int), ("visualize", int), ("mesh_data", int),
                       ("mesh_model", int), ("test_result_dir", str), ("save_wrong", int),
                       ("which_file", str), ("other", str), ("encoder_weights", str),
                       ("recnet_weights", str), ("device", str)):
        p.add_argument(f"--{name}", type=kind, default=getattr(d, name))
    ns = p.parse_args(argv)
    opts = Options(**{k: (tuple(v) if k == "loss_weight" else v) for k, v in vars(ns).items()})
    return opts.finalize(make_dirs=make_dirs)
