"""The port's kernel functions vs the JAX Pallas kernels.

On the CPU each wrapper takes its plain version; the Pallas kernels run in
interpret mode, as tests/test_pallas_kernels.py runs them. The CUDA
kernels are held against the same plain versions on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ffrnet_torch.ops.kernels import _build
from ffrnet_torch.ops.kernels.channel_branch import _collapse, channel_branch
from ffrnet_torch.ops.kernels.se_gating import se_gating
from ffrnet_torch.ops.kernels.self_similarity import self_similarity_fused
from ffrnet_torch.ops.kernels.warp import warp_affine_band, warp_affine_full
from ffrnet_torch.ops.similarity import self_similarity as t_self_similarity
from ffrnet_tpu.ops.pallas.channel_branch import _collapse as j_collapse
from ffrnet_tpu.ops.pallas.channel_branch import channel_branch_pallas
from ffrnet_tpu.ops.pallas.se_gating import se_gating_pallas
from ffrnet_tpu.ops.pallas.self_similarity import self_similarity_pallas
from ffrnet_tpu.ops.similarity import self_similarity as j_self_similarity
from tests.test_torch_cuda import TDT, TOL
from tests.test_torch_cuda import c4c_tree as _c4c_tree
from tests.test_torch_cuda import tree_map as _tree_map

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _nchw(a_nhwc, dtype):
    return torch.from_numpy(np.ascontiguousarray(a_nhwc.transpose(0, 3, 1, 2))).to(TDT[dtype])


def _f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 14, 14, 64), (2, 7, 7, 512)])
def test_se_gating_matches_pallas(shape, dtype):
    rng = np.random.default_rng(5)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w1 = (rng.standard_normal((c // 16, c)) * 0.2).astype(np.float32)
    w2 = (rng.standard_normal((c, c // 16)) * 0.2).astype(np.float32)
    want = se_gating_pallas(jnp.asarray(x, JDT[dtype]), jnp.asarray(w1, JDT[dtype]),
                            jnp.asarray(w2, JDT[dtype]))
    got = se_gating(_nchw(x, dtype), torch.from_numpy(w1).to(TDT[dtype]),
                    torch.from_numpy(w2).to(TDT[dtype]))
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(_f32(got).transpose(0, 2, 3, 1),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("case", ["random", "zero_map", "bfloat16", "plain_impl"])
def test_self_similarity_matches_pallas(case):
    """The fused wrapper vs the Pallas kernel; `plain_impl` holds the port's
    normalize-then-bmm path against the JAX package's XLA path."""
    dtype = "bfloat16" if case == "bfloat16" else "float32"
    x = np.random.default_rng(1).standard_normal((2, 7, 7, 512)).astype(np.float32)
    if case == "zero_map":
        x[1] = 0.0
    if case == "plain_impl":
        ss_j, sc_j = j_self_similarity(jnp.asarray(x), impl="xla")
        ss_t, sc_t = t_self_similarity(_nchw(x, dtype), impl="plain")
    else:
        ss_j, sc_j = self_similarity_pallas(jnp.asarray(x, JDT[dtype]))
        ss_t, sc_t = self_similarity_fused(_nchw(x, dtype))
    for got, want in ((ss_t, ss_j), (sc_t, sc_j)):
        assert np.isfinite(_f32(got)).all()
        np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("biases", [True, False])
def test_collapse_matches_jax(biases):
    tree = _c4c_tree(2, biases)
    want = j_collapse(_tree_map(tree, jnp.asarray))
    got = _collapse(_tree_map(tree, torch.from_numpy))
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        # fp32 products of 512-term sums in another order
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("biases", [True, False])
def test_channel_branch_matches_pallas(biases):
    tree = _c4c_tree(3, biases)
    flat = np.random.default_rng(4).standard_normal((2, 512, 49)).astype(np.float32)
    want = channel_branch_pallas(jnp.asarray(flat), _tree_map(tree, jnp.asarray))
    got = channel_branch(torch.from_numpy(flat), _collapse(_tree_map(tree, torch.from_numpy)))
    assert tuple(got.shape) == (2, 512, 49)  # NCHW; the JAX kernel gives (N, HW, C)
    # 512-term fp32 reassociation in M X (the JAX package's own bound 2e-5,
    # tests/test_pallas_kernels.py)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_wrappers_count_only_kernel_launches():
    """On the CPU every wrapper takes its plain twin, and a plain call is
    not a launch."""
    wrappers = (se_gating, self_similarity_fused, channel_branch, warp_affine_full,
                warp_affine_band)
    for w in wrappers:
        w.launches = 0
    x = torch.randn(1, 512, 7, 7)
    se_gating(x, torch.randn(32, 512), torch.randn(512, 32))
    self_similarity_fused(x)
    tree = _tree_map(_c4c_tree(0, True), torch.from_numpy)
    channel_branch(x.reshape(1, 512, 49), _collapse(tree))
    img, mat = torch.rand(1, 40, 40, 3), torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])
    warp_affine_full(img, mat, out_hw=(8, 8))
    warp_affine_band(img, mat, out_hw=(8, 8))
    assert tuple(w.launches for w in wrappers) == (0, 0, 0, 0, 0)


def test_build_key_tracks_sources():
    """Each kernel library is keyed on its sources and flags, under the
    package's ignored build directory."""
    paths = {n: _build.library_path(n) for n in _build.KERNELS}
    assert len(set(paths.values())) == len(_build.KERNELS) == 4
    for n, p in paths.items():
        assert p.parent == _build.BUILD_DIR and p.name.startswith(f"lib{n}-")
        assert (_build.CSRC / f"{n}.cu").is_file()
