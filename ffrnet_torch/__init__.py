"""PyTorch/CUDA port of FFR-Net (inference, ingest and RecNet training), for
one NVIDIA H100.

The layout mirrors `ffrnet_tpu` so each module's counterpart is easy to
find (`ops/`, `models/`, `checkpoint/`, `eval/`, `training/`, `data/`,
`api.py`). The package imports `torch` and never `jax` or `ffrnet_tpu`.

    from ffrnet_torch.api import FFRNet

    model = FFRNet.random(seed=0)                     # device="cuda"
    raw, rect = model.embed(images_nhwc_uint8)
    scores = model.verify(img1, img2)

Beside the main path's IR-SE50 (`models/irse.py`) and RecNet
(`models/recnet.py`), `models/` holds the reference's model-zoo extras:
MobileFaceNet (`models/mobilefacenet.py`), the Arcface and AmSoftmax margin
heads (`models/heads.py`), and HGBlock and SELayer (`models/hourglass.py`;
SELayer's gate is the se_gating kernel).

Hand-written Hopper kernels (`ffrnet_torch/csrc/*.cu`) carry the SE gate,
the self-similarity Grams, the fused RecNet channel branch and the two
alignment warps; they are built with `nvcc` at first use
(`ops/kernels/_build.py`). The first three are differentiable: their
backward is the VJP of their plain twin (`ops/kernels/_autograd.py`).
"""

__version__ = "0.1.0"
