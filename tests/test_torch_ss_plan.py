"""The self-similarity kernel's launch plan (`_ss_plan`), on the CPU.

The kernel is one launch per call: per sample one ss_space work item and
one item per upper-triangle 128x128 tile pair of ss_channel. The plan
gives the tile, the item counts and the shared memory per CTA. The kernel itself
runs only on the card (tests/test_torch_cuda.py).
"""

import pytest

from ffrnet_torch.ops.kernels.self_similarity import (CTA_RESERVED, HALF, MAX_CTAS_PER_SM,
                                                      MAX_SMEM, SM_SMEM, _smem_bytes,
                                                      _ss_plan)


@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [1, 16, 49, 64])
@pytest.mark.parametrize("c", [64, 128, 192, 256, 512])
def test_ss_plan(c, hw, itemsize):
    plan = _ss_plan(c, hw, itemsize)
    # the tile side divides C, or the last tile holds one valid 64-wide
    # half and the kernel masks the other
    t = plan.tiles
    assert plan.tile == 2 * HALF and (t - 1) * plan.tile < c <= t * plan.tile
    assert c % plan.tile in (0, HALF)
    assert plan.pairs == t * (t + 1) // 2
    # every (I, J) with I <= J once, as the kernel decodes its item index
    seen = set()
    for q in range(plan.pairs):
        rest, ti = q, 0
        while rest >= t - ti:
            rest -= t - ti
            ti += 1
        seen.add((ti, ti + rest))
    assert seen == {(i, j) for i in range(t) for j in range(i, t)}
    assert plan.smem == _smem_bytes(hw, itemsize) <= MAX_SMEM
    assert 1 <= plan.ctas_per_sm <= MAX_CTAS_PER_SM
    assert plan.ctas_per_sm * (plan.smem + CTA_RESERVED) <= SM_SMEM
    # the copied panels hold two 64-row panels of X as they are
    assert plan.smem >= 2 * plan.tile * hw * itemsize


@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
def test_ss_plan_recnet(itemsize):
    """RecNet's (512, 7x7): 10 of the 16 tiles of ss_channel, two CTAs an SM."""
    plan = _ss_plan(512, 49, itemsize)
    assert (plan.tile, plan.tiles, plan.pairs) == (128, 4, 10)
    assert plan.ctas_per_sm == 2


@pytest.mark.parametrize("c, hw", [(0, 49), (32, 49), (96, 49), (500, 49), (512, 65),
                                   (512, 0), (64, 14 * 14)])
def test_ss_plan_rejects(c, hw):
    with pytest.raises(ValueError, match="C % 64 == 0"):
        _ss_plan(c, hw, 4)
