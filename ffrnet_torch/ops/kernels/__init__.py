"""Hand-written Hopper kernels of the port and their plain PyTorch twins.

Each wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises. Each keeps a launch count
(`wrapper.launches`) that only a kernel launch increments.

The four inference kernels are PyTorch operators in the `ffrnet`
namespace (`_ops.py`): se_gating, channel_branch, self_similarity and
int8_conv, so that PyTorch's dispatcher picks kernel or twin at run time
and a traced program (tools/export_model.py) holds them; importing this
package registers them. se_gating, self_similarity and channel_branch are
differentiable, their backward the VJP of the plain version
(`_autograd.py`), which launches no kernel. int8_conv serves inference
only (the frozen encoder and RecNet's conv chains, ops/quant.py). The two
warps stay Python wrappers: export takes aligned faces, so no warp is on
its path.
"""

from ffrnet_torch.ops.kernels.channel_branch import channel_branch
from ffrnet_torch.ops.kernels.int8_conv import int8_conv
from ffrnet_torch.ops.kernels.se_gating import se_gating
from ffrnet_torch.ops.kernels.self_similarity import self_similarity_fused
from ffrnet_torch.ops.kernels.warp import warp_affine_band, warp_affine_full

WRAPPERS = {
    "se_gating": se_gating,
    "self_similarity": self_similarity_fused,
    "channel_branch": channel_branch,
    "warp_affine_full": warp_affine_full,
    "warp_affine_band": warp_affine_band,
    "int8_conv": int8_conv,
}


def reset_launch_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def launch_counts() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}
