"""Hand-written Hopper kernels of the port and their plain PyTorch twins.

Each wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises. Each keeps a launch count
(`wrapper.launches`) that only a kernel launch increments. se_gating,
self_similarity and channel_branch are `torch.autograd.Function`s whose
backward is the VJP of the plain version (`_autograd.py`); the backward
launches no kernel.
"""

from ffrnet_torch.ops.kernels.channel_branch import channel_branch
from ffrnet_torch.ops.kernels.se_gating import se_gating
from ffrnet_torch.ops.kernels.self_similarity import self_similarity_fused
from ffrnet_torch.ops.kernels.warp import warp_affine_band, warp_affine_full

WRAPPERS = {
    "se_gating": se_gating,
    "self_similarity": self_similarity_fused,
    "channel_branch": channel_branch,
    "warp_affine_full": warp_affine_full,
    "warp_affine_band": warp_affine_band,
}


def reset_launch_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def launch_counts() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}
