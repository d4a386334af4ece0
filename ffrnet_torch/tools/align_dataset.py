"""Offline batch face alignment (reference lfw/gen_lfw112x96.py) on the card.

Counterpart of ffrnet_tpu/tools/align_dataset.py. Reads `lfw_landmark.txt`
(tab-separated `person/img.jpg` + 10 ints, gen_lfw112x96.py:22-26),
aligns every image to the canonical ArcFace 5-point frame in batches
(cp2tform on the host, the warp kernels on the card) and writes the crops.

    python -m ffrnet_torch.tools.align_dataset \\
        --src_root LFW/images --landmarks LFW/lfw_landmark.txt \\
        --save_root out/lfw112x96 [--out_h 112 --out_w 96] [--batch 256] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List

import numpy as np
import torch

from ffrnet_torch.api import decode_canvas, resolve_device
from ffrnet_torch.ops.align import align_faces


def read_landmarks(path: str) -> Dict[str, List[int]]:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 11:
                out[parts[0]] = [int(x) for x in parts[1:11]]
    return out


def align_tree(src_root: str, landmarks_txt: str, save_root: str, *, out_hw=(112, 96),
               batch: int = 256, device="cuda") -> int:
    """Align every image under `src_root` that `landmarks_txt` names into
    the same relative path under `save_root` (`align_faces`' guarded warp);
    returns the count."""
    from PIL import Image  # encodes the crops

    dev = resolve_device(device)
    landmarks = read_landmarks(landmarks_txt)
    items = []
    for person in sorted(os.listdir(src_root)):
        pdir = os.path.join(src_root, person)
        if not os.path.isdir(pdir):
            continue
        for img_name in sorted(os.listdir(pdir)):
            key = f"{person}/{img_name}"
            if key in landmarks:
                items.append((key, landmarks[key]))

    n_done = 0
    for i in range(0, len(items), batch):
        chunk = items[i:i + batch]
        # uint8 across the link, cast to float32 on the device
        canvas = decode_canvas([os.path.join(src_root, key) for key, _ in chunk])
        pts = np.stack([np.asarray(lm, np.float32).reshape(5, 2) for _, lm in chunk])
        aligned = align_faces(torch.from_numpy(canvas).to(dev), pts, out_hw=out_hw)
        aligned = aligned.cpu().numpy().clip(0, 255).astype(np.uint8)
        for (key, _), crop in zip(chunk, aligned):
            dst = os.path.join(save_root, key)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            Image.fromarray(crop).save(dst)
            n_done += 1
    return n_done


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--src_root", required=True)
    p.add_argument("--landmarks", required=True)
    p.add_argument("--save_root", required=True)
    p.add_argument("--out_h", type=int, default=112)
    p.add_argument("--out_w", type=int, default=96)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="cuda (the warp kernels) or cpu (their plain twins)")
    args = p.parse_args(argv)
    n = align_tree(args.src_root, args.landmarks, args.save_root,
                   out_hw=(args.out_h, args.out_w), batch=args.batch, device=args.device)
    print(f"aligned {n} faces -> {args.save_root}")


if __name__ == "__main__":
    main()
