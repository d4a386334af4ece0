"""The SE-gating kernel's launch plan (`_se_plan`), on the CPU.

The kernel holds each sample's map in the shared memory of a cluster of K
CTAs, one contiguous range of C/K channels each; the plan picks K. The
kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import pytest

from ffrnet_torch.ops.kernels.se_gating import (CTA_RESERVED, MAX_CLUSTER, SM_SMEM,
                                                _se_plan, _smem_bytes)

# (H, C) of the four IR-SE50 stages, and the cluster sizes the plan gives
# them in both types: a 98 KB channel slice per CTA and two CTAs an SM in
# fp32, a 49 KB slice and four CTAs an SM in bf16
STAGES = ((56, 64), (28, 128), (14, 256), (7, 512))
CLUSTERS = (8, 4, 2, 1)


@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("stage", range(4))
def test_se_plan_irse50_stages(stage, itemsize):
    h, c = STAGES[stage]
    hw, r = h * h, c // 16
    cluster, cpc, smem = _se_plan(c, hw, r, itemsize)
    assert cluster == CLUSTERS[stage]
    assert cpc * cluster == c
    slice_bytes = cpc * hw * itemsize
    assert slice_bytes % 16 == 0  # the bulk copy's unit
    assert slice_bytes == 25_088 * itemsize
    assert smem == _smem_bytes(cpc, hw, r, itemsize) and smem - slice_bytes < 5_000
    ctas_per_sm = 2 if itemsize == 4 else 4
    assert ctas_per_sm * (smem + CTA_RESERVED) <= SM_SMEM


@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
def test_se_plan_pallas_test_shape(itemsize):
    """tests/test_pallas_kernels.py's (2, 14, 14, 64): one CTA per sample."""
    cluster, cpc, smem = _se_plan(64, 14 * 14, 4, itemsize)
    assert (cluster, cpc, smem) == (1, 64, _smem_bytes(64, 196, 4, itemsize))


@pytest.mark.parametrize("c, hw, itemsize", [
    (64, 112 * 112, 4),  # a 224x224 input's first stage: 3.2 MB a sample
    (1024, 28 * 28, 4),  # 3.2 MB a sample at 28x28
    (4, 9, 2),           # 72 bytes a sample: no slice of 16-byte multiples
])
def test_se_plan_rejects_maps_no_cluster_holds(c, hw, itemsize):
    with pytest.raises(ValueError, match=f"at most {MAX_CLUSTER} CTAs"):
        _se_plan(c, hw, max(c // 16, 1), itemsize)


def test_se_plan_bf16_at_two_per_sm_halves_the_clusters():
    """The alternative chip_smoke.py times bf16 against: 98 KB slices, two
    CTAs an SM, half the CTAs (a 49 KB slice at 7x7, whose whole map is
    49 KB)."""
    plans = [_se_plan(c, h * h, c // 16, 2, ctas_per_sm=2) for h, c in STAGES]
    assert [p[0] for p in plans] == [4, 2, 1, 1]
    assert all(2 * (smem + CTA_RESERVED) <= SM_SMEM for _, _, smem in plans)
