"""Experiment logger: tensorboard scalars/images/text, plain text and
JSON (a copy of ffrnet_tpu/utils/logger.py).

Scalars per loss each iteration, eval accuracies under test_acc/ocl{0,1,2},
config text, per-phase txt logs, a JSON export of every scalar on close,
event dirs named `exp_<datetime>_<hostname>`. tensorboardX is optional:
without it the scalars still go to the txt and JSON sinks.
"""

from __future__ import annotations

import json
import os
import socket
from collections import OrderedDict, defaultdict
from datetime import datetime
from typing import Dict, Optional

import numpy as np


def mkdirs(path: str) -> None:
    os.makedirs(path, exist_ok=True)


class Logger:
    def __init__(self, log_root: str, run_name: str, phase: str = "train"):
        self.log_dir = os.path.join(log_root, run_name)
        mkdirs(self.log_dir)
        self.phase_keys = ["train", "val", "test"]
        self.txt_files = {
            p: os.path.join(self.log_dir, f"log_{p}") for p in self.phase_keys}
        self.mode = phase if phase in self.phase_keys else "train"
        self.cur_iter = 0
        self.cur_epoch = 0
        self.iter_log = OrderedDict()
        self._scalars = defaultdict(list)  # tag -> [(iter, value)]

        events_dir = "exp_{}_{}".format(
            datetime.now().strftime("%Y-%m-%d_%H:%M:%S"), socket.gethostname())
        self.writer = None
        try:
            from tensorboardX import SummaryWriter

            self.writer = SummaryWriter(os.path.join(self.log_dir, events_dir))
        except ImportError:
            pass

    def set_mode(self, mode: str):
        self.mode = mode

    def set_current_iter(self, cur_iter: int, cur_epoch: Optional[int] = None):
        self.cur_iter = cur_iter
        if cur_epoch is not None:
            self.cur_epoch = cur_epoch
        self.iter_log = OrderedDict()

    def record_scalar(self, items: Dict, tag: str):
        self.iter_log.update(items)
        for k, v in items.items():
            full = f"{tag}/{k}"
            self._scalars[full].append((self.cur_iter, float(v)))
            if self.writer is not None:
                self.writer.add_scalar(full, float(v), self.cur_iter)

    def print_scalar(self, items: Dict):
        self.iter_log.update(items)

    def record_text(self, tag: str, text: str):
        if self.writer is not None:
            self.writer.add_text(tag, text)
        with open(os.path.join(self.log_dir, f"{tag.replace('/', '_')}.txt"),
                  "w") as f:
            f.write(text)

    def record_single_image(self, img: np.ndarray, tag: str):
        if self.writer is not None:
            self.writer.add_image(tag, img.astype(np.uint8), self.cur_iter,
                                  dataformats="HWC")

    def record_images(self, visuals, nrow: int = 6, tag: str = "ckpt_image"):
        imgs = []
        for i in range(nrow):
            imgs.append(np.hstack([np.asarray(x[i]) for x in visuals]))
        grid = np.vstack(imgs)
        self.record_single_image(grid, tag)

    def print_iter_summary(self, total_it: int, total_epoch: int, timer) -> str:
        msg = "{}\nEpoch[Iter]: {:03d}/{:03d}[{:03d}/{:03d}]\t".format(
            timer.to_string(total_it - self.cur_iter),
            self.cur_epoch, total_epoch, self.cur_iter, total_it)
        for k, v in self.iter_log.items():
            msg += f"{k}: {v}\t"
        print(msg + "\n", flush=True)
        with open(self.txt_files[self.mode], "a+") as f:
            f.write(msg + "\n")
        return msg

    def close(self):
        out = {tag: {"iters": [i for i, _ in vals],
                     "values": [v for _, v in vals]}
               for tag, vals in self._scalars.items()}
        with open(os.path.join(self.log_dir, "all_scalars.json"), "w") as f:
            json.dump(out, f)
        if self.writer is not None:
            self.writer.close()
