"""Minimal user journey: load (or random-init) the models, embed aligned
faces, score verification pairs (examples/embed_and_verify.py).

    python -m ffrnet_torch.examples.embed_and_verify [se50.pth [FFRNet.pth]] [--device cuda]
"""

import argparse

import numpy as np


def main(argv=None):
    from ffrnet_torch.api import FFRNet

    ap = argparse.ArgumentParser()
    ap.add_argument("weights", nargs="*", help="se50.pth [FFRNet.pth]")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.weights:
        model = FFRNet.from_pretrained(args.weights[0],
                                       args.weights[1] if len(args.weights) > 1 else "",
                                       device=args.device)
    else:
        print("(no weights given: random init — scores are meaningless)")
        model = FFRNet.random(0, device=args.device)

    # aligned 112x112 BGR faces in [-1, 1] — see FFRNet.align / embed_files
    # for the raw-image ingest path
    rng = np.random.default_rng(0)
    faces = rng.uniform(-1, 1, (8, 112, 112, 3)).astype(np.float32)

    raw, rect = model.embed(faces)
    print(f"raw embeddings {tuple(raw.shape)}, rectified {tuple(rect.shape)}")

    scores = model.verify(faces[:4], faces[4:])  # rectified cosine per pair
    print("pair scores:", scores.float().cpu().numpy().round(4))


if __name__ == "__main__":
    main()
