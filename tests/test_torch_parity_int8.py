"""The int8 arm of the port's parity_check.run_lfw on the CPU (--int8 1:
the int8-static deployment model, BN folded, bf16, every int8 site,
calibrated on 8 faces), on the `.pth` files of test_torch_parity_check and
the first 10 pairs of conftest's lfw_tree (the int8 CPU twin is a float64
product, slow beyond a few faces): the JAX tool's keys in every ocl cell,
accuracies in [0, 1], d_int8 the rounded unrounded deltas and the flag
computed from them."""

import torch

from ffrnet_torch.tools import parity_check
from tests.test_torch_parity_check import weights  # noqa: F401 (a fixture)

torch.set_num_threads(2)


def test_run_lfw_int8_arm(weights, lfw_tree, tmp_path):
    """--int8 on the first 10 pairs of lfw_tree (the int8 CPU twin is a
    float64 product): every cell has the int8 keys, accuracies in [0, 1],
    d_int8 the rounded unrounded deltas and a bool flag from them."""
    enc_path, rec_path, _, _ = weights
    root, pairs = lfw_tree
    lines = open(pairs).read().splitlines(keepends=True)
    short = tmp_path / "pairs10.txt"
    short.write_text("".join(lines[:11]))
    out = parity_check.run_lfw(enc_path, rec_path, str(root), str(short), batch_size=10,
                               int8=True, device="cpu")
    assert set(out) == {"ocl0", "ocl1", "ocl2"}
    for cell in out.values():
        assert set(cell) == {"acc_new", "acc", "acc_new_int8", "acc_int8", "d_int8",
                             "int8_within_0.1pct"}
        for k in ("acc_new", "acc", "acc_new_int8", "acc_int8"):
            assert 0.0 <= cell[k] <= 1.0
        d = [cell["acc_new_int8"] - cell["acc_new"], cell["acc_int8"] - cell["acc"]]
        assert cell["d_int8"] == [round(v, 4) for v in d]
        assert cell["int8_within_0.1pct"] is (max(abs(v) for v in d) <= 0.001)
