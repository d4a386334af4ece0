"""The channel-branch kernel's launch plan (`_cb_plan`), on the CPU.

A cluster of up to 8 CTAs (a power of two) shares one sample, and each CTA
owns C / cluster rows of the attention matrix, in blocks of 64. The kernel
itself runs only on the card (tests/test_torch_cuda.py).
"""

import pytest

from ffrnet_torch.ops.kernels.channel_branch import MAX_CLUSTER, ROWS, _cb_plan


@pytest.mark.parametrize("c, plan", [
    (512, (8, 64)),    # RecNet: eight CTAs of 64 rows
    (64, (1, 64)),
    (128, (2, 64)),
    (256, (4, 64)),
    (1024, (8, 128)),  # two blocks of 64 rows a CTA
    (192, (1, 192)),   # three blocks: no cluster of 2 or more divides them
    (384, (2, 192)),
])
def test_cb_plan(c, plan):
    cluster, rows = _cb_plan(c)
    assert (cluster, rows) == plan
    assert cluster * rows == c and rows % ROWS == 0
    assert cluster <= MAX_CLUSTER and cluster & (cluster - 1) == 0


@pytest.mark.parametrize("c", [0, 32, 96, 500])
def test_cb_plan_rejects_c_not_a_multiple_of_64(c):
    with pytest.raises(ValueError, match="C % 64 == 0"):
        _cb_plan(c)
