"""Train the full FFR-Net objective on synthetic paired data (no CASIA
needed): the smallest complete training loop (examples/train_synthetic.py).

    python -m ffrnet_torch.examples.train_synthetic [steps] [--device cuda]

IR-SE50 (frozen, seed 0) and RecNet (C=512, 32 classes, seed 1), Adam lr
1e-3, bf16 compute, batch 16. For the real thing use the driver (the same
train_step underneath):
    python -m ffrnet_torch.train --phase train --train_data <casia_root> ...
"""

import argparse

import numpy as np

N_IDS, BATCH = 32, 16


def synthetic_batches(steps: int, n_ids: int = N_IDS, batch: int = BATCH, seed: int = 0):
    """The example's host batches, the JAX example's numpy stream: a fixed
    clean face per identity; each batch draws labels, adds noise, and its
    "masked" twin zeroes the lower half (the occlusion the objective must
    rectify)."""
    rng = np.random.default_rng(seed)
    bank = rng.uniform(-1, 1, (n_ids, 112, 112, 3)).astype(np.float32)
    for _ in range(steps):
        labels = rng.integers(0, n_ids, batch)
        clean = bank[labels] + rng.normal(0, 0.05, (batch, 112, 112, 3)).astype(np.float32)
        masked = clean.copy()
        masked[:, 56:] = 0.0
        yield {"img_non": clean, "img_ocl": masked, "label": labels.astype(np.int32)}


def main(argv=None):
    import torch

    from ffrnet_torch.api import resolve_device
    from ffrnet_torch.models.irse import build_backbone
    from ffrnet_torch.models.recnet import RecNetConfig
    from ffrnet_torch.training.trainer import TrainerConfig, create_train_state, train_step

    ap = argparse.ArgumentParser()
    ap.add_argument("steps", nargs="?", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = TrainerConfig(optimizer="adam", lr=1e-3, compute_dtype="bf16",
                        recnet=RecNetConfig(num_classes=N_IDS))
    encoder = build_backbone(generator=torch.Generator().manual_seed(0),
                             device=dev).to(torch.bfloat16)  # frozen
    state = create_train_state(cfg, seed=1, device=dev)
    for i, batch in enumerate(synthetic_batches(args.steps)):
        state, m = train_step(encoder, state, batch, cfg=cfg)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  total={float(m['TotalLoss']):.4f}  "
                  f"acc={float(m['TrainAcc']):.3f}")


if __name__ == "__main__":
    main()
