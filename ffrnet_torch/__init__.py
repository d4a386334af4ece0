"""PyTorch/CUDA port of the FFR-Net inference path, for one NVIDIA H100.

The layout mirrors `ffrnet_tpu` so each module's counterpart is easy to
find (`ops/`, `models/`, `checkpoint/`, `eval/`, `api.py`). The package
imports `torch` and never `jax` or `ffrnet_tpu`.

    from ffrnet_torch.api import FFRNet

    model = FFRNet.random(seed=0)                     # device="cuda"
    raw, rect = model.embed(images_nhwc_uint8)
    scores = model.verify(img1, img2)

Three hand-written Hopper kernels (`ffrnet_torch/csrc/*.cu`) carry the
SE gate, the self-similarity Grams and the fused RecNet channel branch;
they are built with `nvcc` at first use (`ops/kernels/_build.py`).
"""

__version__ = "0.1.0"
