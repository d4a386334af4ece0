"""Int8 serving quickstart (examples/int8_serving.py): BN folded, bf16,
int8 weights over the encoder and RecNet's conv chains, static activation
scales calibrated on two batches, then embeddings through the
micro-batching EmbeddingService.

    python -m ffrnet_torch.examples.int8_serving [se50.pth [FFRNet.pth]] [--device cuda]

Calibrate on a few batches of real aligned faces: the static scales clip
activations beyond the calibrated range. The synthetic batches below only
make the example self-contained.
"""

import argparse

import numpy as np
import torch


def main(argv=None):
    from ffrnet_torch.api import FFRNet
    from ffrnet_torch.serving import EmbeddingService

    ap = argparse.ArgumentParser()
    ap.add_argument("weights", nargs="*", help="se50.pth [FFRNet.pth]")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.weights:
        model = FFRNet.from_pretrained(args.weights[0],
                                       args.weights[1] if len(args.weights) > 1 else "",
                                       fold_bn=False, device=args.device)
    else:
        print("(no weights given: random init — embeddings are meaningless)")
        model = FFRNet.random(0, device=args.device)

    model = model.prepare(fold_bn=True, dtype=torch.bfloat16, quantize_int8="all")
    rng = np.random.default_rng(0)
    cal = [rng.uniform(-1, 1, (8, 112, 112, 3)).astype(np.float32) for _ in range(2)]
    model = model.calibrate_int8(cal)

    svc = EmbeddingService(model, max_batch=256)
    try:
        svc.warmup()
        faces = rng.uniform(-1, 1, (8, 112, 112, 3)).astype(np.float32)
        raw, rectified = svc.submit(faces).result(timeout=600)
        print(f"int8 embeddings: raw {tuple(raw.shape)} rectified {tuple(rectified.shape)}")
    finally:
        svc.close()


if __name__ == "__main__":
    main()
