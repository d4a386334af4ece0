"""The canonical experiment launcher (ffrnet_tpu/run.py): the paper's
training configuration as code, run through the port's driver in-process.

    python -m ffrnet_torch.run            # train with the canonical config
    python -m ffrnet_torch.run --debug    # debug mode (1 iter/epoch)

Further flags are appended to the canonical ones (a later flag wins), e.g.
`--device cpu` or `--test_data ... --test_pair_list ...`. The canonical
values: model FFR-Net, Adam, lr 1e-1, beta1 0.9, weight_decay 0,
loss_weight [1,1,1,1], batch 64, 200 epochs, print/save/eval every
100/4000/1000 iterations.
"""

from __future__ import annotations

import sys


def build_args(debug: bool = False):
    phase = "train"
    train_data = "../CASIA-WebFace_112_align_v1_masked"
    model_name = "FFR-Net"
    optimizer = "Adam"
    lr = 1e-1
    beta1 = 0.9
    momentum = 0.9
    weight_decay = 0.0
    loss_weight = [1, 1, 1, 1]  # ss, triplet, id, cls
    batch_size = 64 if not debug else 32
    total_epochs = 200 if not debug else 10000
    print_freq = 100 if not debug else 1
    save_freq = 4000 if not debug else 100000
    eval_freq = 1000 if not debug else 2
    other = "debug" if debug else "train"

    return [
        "--phase", phase,
        "--debug", str(int(debug)),
        "--train_data", train_data,
        "--batch_size", str(batch_size),
        "--total_epochs", str(total_epochs),
        "--model_name", model_name,
        "--optimizer", optimizer,
        "--lr", str(lr),
        "--beta1", str(beta1),
        "--momentum", str(momentum),
        "--weight_decay", str(weight_decay),
        "--loss_weight", *[str(w) for w in loss_weight],
        "--print_freq", str(print_freq),
        "--save_freq", str(save_freq),
        "--eval_freq", str(eval_freq),
        "--continue_train", "0",
        "--which_file", "debug" if debug else "latest",
        "--other", other,
    ]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    debug = False
    if "--debug" in argv:
        i = argv.index("--debug")
        # accept both bare `--debug` and the reference-style `--debug 1`
        if i + 1 < len(argv) and argv[i + 1] in ("0", "1"):
            debug = argv[i + 1] == "1"
            del argv[i:i + 2]
        else:
            debug = True
            del argv[i]
    from ffrnet_torch.train import main as train_main

    train_main(build_args(debug) + argv)
    print("Train done.")


if __name__ == "__main__":
    main()
