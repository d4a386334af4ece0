"""The int8_conv kernel's plan (ffrnet_torch/ops/kernels/int8_conv.py::
_int8_plan) on the CPU, for every int8 site shape of IR-SE50 and RecNet at
N 1, 3, 64 and 256 and both output types: the work the kernel then does
(`_int8_schedule`, its walk over tiles and K stages) covers every output
tile once, splits K in whole stages within one cluster of at most 8 CTAs,
and fits the card's shared memory and one wave of CTAs.

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 3); its plain twin is held against ffrnet_tpu in
tests/test_torch_quant.py and tests/test_torch_int8_model.py.
"""

import pytest
import torch

from ffrnet_torch.ops.kernels.int8_conv import (BM, CTAS_PER_SM, MAX_CLUSTER, SMEM_LIMIT,
                                                _int8_plan, _int8_schedule, _out_hw,
                                                _round_up)

SMS = 132  # an H100 SXM's streaming multiprocessors
# (Cin, Cout, input H = W, window, stride, padding) of every int8 site shape
# (chip_smoke.py INT8_SITES): IR-SE50's 16 with the Linear (Cin 0, K 25088),
# and RecNet's 9 on 9x9 maps
SITES = [(64, 64, 112, 3, 1, 1), (64, 64, 112, 3, 2, 1), (64, 64, 56, 3, 1, 1),
         (64, 128, 56, 3, 1, 1), (128, 128, 56, 3, 2, 1), (64, 128, 56, 1, 2, 0),
         (128, 128, 28, 3, 1, 1), (128, 256, 28, 3, 1, 1), (256, 256, 28, 3, 2, 1),
         (128, 256, 28, 1, 2, 0), (256, 256, 14, 3, 1, 1), (256, 512, 14, 3, 1, 1),
         (512, 512, 14, 3, 2, 1), (256, 512, 14, 1, 2, 0), (512, 512, 7, 3, 1, 1),
         (0, 512, 1, 1, 1, 0),
         (561, 256, 9, 3, 1, 0), (256, 256, 9, 3, 1, 0), (256, 128, 9, 3, 1, 0),
         (128, 128, 9, 3, 1, 0), (128, 49, 9, 3, 1, 0), (49, 49, 9, 3, 1, 0),
         (1024, 512, 9, 3, 1, 0), (512, 512, 9, 3, 1, 0), (1536, 512, 9, 3, 1, 0)]


def _operands(site):
    """(H, Cp, Coutp, window, stride, padding) as to_nhwc and pack_weight pad them."""
    cin, cout, h, k, stride, pad = site
    cp = 25088 if cin == 0 else _round_up(cin, 64)
    return h, cp, _round_up(cout, 64), k, stride, pad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 3, 64, 256])
@pytest.mark.parametrize("site", SITES, ids=lambda s: "x".join(map(str, s)))
def test_int8_plan_covers_every_tile_once(site, n, dtype):
    h, cp, coutp, k, stride, pad = _operands(site)
    plan = _int8_plan(n, h, h, cp, coutp, k, k, stride, pad, getattr(torch, dtype), SMS)
    ho, wo = _out_hw(h, h, k, k, stride, pad)
    m = n * ho * wo
    # tiles: BM-row blocks covering the N Ho Wo output rows, BN-column blocks
    # covering the padded output channels exactly
    assert plan.bm == BM and (plan.m_tiles - 1) * BM < m <= plan.m_tiles * BM
    assert plan.bn in (64, 128, 256) and plan.n_tiles * plan.bn == coutp
    assert plan.tiles == plan.m_tiles * plan.n_tiles
    # K: every window tap in stages of BK channels (64 only where Cp is 64)
    assert plan.bk == (64 if cp == 64 else 128)
    assert plan.kstages == k * k * -(-cp // plan.bk)
    # the kernel's walk: each tile once, its K stages split over the CTAs of
    # one cluster in contiguous whole-stage ranges
    parts = {}
    for cta, tile, k_begin, k_count in _int8_schedule(plan):
        assert 0 <= cta < plan.grid and k_count >= 1
        parts.setdefault(tile, []).append((k_begin, k_count, cta // plan.cluster))
    assert sorted(parts) == list(range(plan.tiles))
    for ranges in parts.values():
        ranges.sort()
        assert len(ranges) == plan.cluster and len({c for _, _, c in ranges}) == 1
        assert ranges[0][0] == 0
        assert all(b + c == nb for (b, c, _), (nb, _, _) in zip(ranges, ranges[1:]))
        assert ranges[-1][0] + ranges[-1][1] == plan.kstages
    # resources: a cluster of 1-8, the card's shared memory, one wave
    assert 1 <= plan.cluster <= MAX_CLUSTER and plan.cluster & (plan.cluster - 1) == 0
    assert plan.smem <= SMEM_LIMIT
    assert plan.grid <= SMS * CTAS_PER_SM
    if plan.cluster > 1:
        assert plan.grid == plan.tiles * plan.cluster < SMS * CTAS_PER_SM + plan.cluster
    else:
        assert plan.grid == min(plan.tiles, SMS)


@pytest.mark.parametrize("site, n, want", [((0, 512, 1, 1, 1, 0), 256, (64, 16, 8)),
                                           ((256, 256, 14, 3, 1, 1), 1, (64, 8, 8)),
                                           ((64, 64, 112, 3, 1, 1), 1, (64, 98, 1))])
def test_int8_plan_splits_k_below_one_wave(site, n, want):
    """Fewer tiles than SMs: the narrowest tiles, K split over the largest
    cluster (at most 8) that keeps the grid within the SMs. The Linear at
    N=256 runs 16 tiles of 64 columns on 128 CTAs; the 112x112 site at N=1
    has 98 tiles, too many to pair."""
    h, cp, coutp, k, stride, pad = _operands(site)
    plan = _int8_plan(n, h, h, cp, coutp, k, k, stride, pad, torch.float32, SMS)
    assert (plan.bn, plan.tiles, plan.cluster) == want
    assert plan.grid == plan.tiles * plan.cluster <= SMS


def test_int8_plan_rejects_other_output_types():
    with pytest.raises(TypeError):
        _int8_plan(1, 14, 14, 256, 256, 3, 3, 1, 1, torch.float16, SMS)
