"""The port's parity_check.run_lfw against ffrnet_tpu's on the CPU, on the
`.pth` files of test_torch_parity_check (written by the port's save_pth
from seeded JAX trees) and conftest's lfw_tree: the float arm's report, fold
accuracies and thresholds bit-equal to the JAX tool's at ocl 0, 1 and 2."""

import numpy as np
import torch

from ffrnet_torch.eval import runner
from ffrnet_torch.tools import parity_check
from ffrnet_tpu.eval import runner as j_runner
from ffrnet_tpu.tools import parity_check as j_parity_check
from tests.test_torch_parity_check import weights  # noqa: F401 (a fixture)

torch.set_num_threads(2)

TOL = 1e-5


def _recording(real, seen):
    def run(*args, **kwargs):
        out = real(*args, **dict(kwargs, return_scores=True))
        seen.append(out)
        return out[:2]
    return run


def test_run_lfw_float_arm_bit_equal_jax(weights, lfw_tree, monkeypatch):
    """run_lfw at ocl 0/1/2: the same report as the JAX tool's, and the same
    fold accuracies and thresholds, bit for bit (scores within 1e-5)."""
    enc_path, rec_path, _, _ = weights
    root, pairs = lfw_tree
    seen = {"port": [], "jax": []}
    monkeypatch.setattr(runner, "evaluate_pairs", _recording(runner.evaluate_pairs,
                                                             seen["port"]))
    monkeypatch.setattr(j_runner, "evaluate_pairs", _recording(j_runner.evaluate_pairs,
                                                               seen["jax"]))
    ours = parity_check.run_lfw(enc_path, rec_path, str(root), str(pairs), device="cpu")
    theirs = j_parity_check.run_lfw(enc_path, rec_path, str(root), str(pairs))
    assert ours == theirs
    assert set(ours) == {"ocl0", "ocl1", "ocl2"}
    assert len(seen["port"]) == len(seen["jax"]) == 3
    for res, jres in zip(seen["port"], seen["jax"]):
        for r, jr in zip(res[:2], jres[:2]):
            np.testing.assert_array_equal(r.fold_accuracies.numpy(),
                                          np.asarray(jr.fold_accuracies))
            np.testing.assert_array_equal(r.best_thresholds.numpy(),
                                          np.asarray(jr.best_thresholds))
        for s, js in zip(res[2:4], jres[2:4]):
            assert s.shape == (60,)
            np.testing.assert_allclose(s, np.asarray(js), atol=TOL, rtol=0)
        np.testing.assert_array_equal(res[4], np.asarray(jres[4]))
