"""torch.export of the inference graph (ffrnet_torch/tools/export_model.py) on the CPU.

The port's counterpart of the JAX package's StableHLO export
(tests/test_export.py): one program with a symbolic batch, saved and loaded
with torch.export, holding the port's kernels as `ffrnet.*` operators (on
the CPU they run their plain twins). The loaded program is held to
`FFRNet.embed`; tests/test_torch_export_vs_jax.py holds it to the JAX
package's artifact. Inputs are made with numpy from a seed.
"""

import collections
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from ffrnet_torch.api import FFRNet
from ffrnet_torch.models.quantize import quantized_sites
from ffrnet_torch.models.recnet import SS_KERNEL_CONFIG
from ffrnet_torch.tools.export_model import export_embed, input_shape, main

torch.set_num_threads(1)

# the JAX package's bound for its exported artifact against the live model
# (tests/test_export.py:36-39)
EXPORT_TOL = dict(atol=1e-4, rtol=1e-4)


def faces(n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 112, 112, 3)).astype(np.float32)


def _ops(program):
    return collections.Counter(str(n.target) for n in program.graph.nodes
                               if n.op == "call_function" and str(n.target).startswith("ffrnet."))


def reload(program):
    buf = io.BytesIO()
    torch.export.save(program, buf)
    buf.seek(0)
    return torch.export.load(buf)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The tool run as a user would on the CPU: FFRNet.random(0), fp32,
    symbolic batch; -> (the file, the printed JSON line)."""
    path = tmp_path_factory.mktemp("export") / "ffrnet.pt2"
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        main(["--device", "cpu", "--out", str(path)])
    return path, stdout.getvalue().strip().splitlines()[-1]


def test_cli_prints_the_json_line(cli):
    path, line = cli
    out = json.loads(line)
    assert set(out) == {"out", "bytes", "in_shape", "devices", "roundtrip_maxerr"}
    assert out["out"] == str(path) and out["bytes"] == path.stat().st_size
    assert out["in_shape"] == ["b", 112, 112, 3] and out["devices"] == ["cpu"]
    assert out["roundtrip_maxerr"] <= 1e-4


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--out", "unused.pt2"])


def test_round_trip_symbolic_batch(cli):
    """The saved fused fp32 program: 24 SE gates and one channel branch as
    operators, the batch symbolic from 1, and N = 1, 3 and 8 within the
    JAX export's bound of the live model's embed."""
    program = torch.export.load(str(cli[0]))
    assert _ops(program) == {"ffrnet.se_gating.default": 24,
                             "ffrnet.channel_branch.default": 1}
    assert input_shape(program) == ["b", 112, 112, 3]
    (batch_range,) = program.range_constraints.values()
    assert batch_range.lower == 1
    run = program.module()
    model = FFRNet.random(0, device="cpu")
    for n in (1, 3, 8):
        x = faces(n, n)
        with torch.no_grad():
            got = run(torch.from_numpy(x))
        for a, b in zip(got, model.embed(x)):
            assert tuple(a.shape) == (n, 512)
            np.testing.assert_allclose(a.numpy(), b.numpy(), **EXPORT_TOL)


def test_ss_kernel_configuration():
    model = FFRNet.random(0, cfg=SS_KERNEL_CONFIG, device="cpu")
    program = export_embed(model)
    assert _ops(program) == {"ffrnet.se_gating.default": 24,
                             "ffrnet.self_similarity.default": 1}
    x = faces(2, 11)
    with torch.no_grad():
        got = program.module()(torch.from_numpy(x))
    for a, b in zip(got, model.embed(x)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **EXPORT_TOL)


def test_int8_all_model_keeps_its_int8_operands():
    """The calibrated bf16 int8 "all" model: 52 encoder + 15 RecNet sites,
    each one `int8_conv` node; after save/load the weights are still int8
    and the scales fp32 (trace only, as tests/test_export.py:43-58). A model
    armed for calibration refuses to export."""
    base = FFRNet.random(0, device="cpu").prepare(fold_bn=True, dtype=torch.bfloat16,
                                                  quantize_int8="all")
    model = base.calibrate_int8([faces(2, 12)])
    program = reload(export_embed(model))
    assert _ops(program) == {"ffrnet.se_gating.default": 24,
                             "ffrnet.channel_branch.default": 1,
                             "ffrnet.int8_conv.default": 67}
    tensors = {**program.state_dict, **program.constants}
    sites = {name: site for part in ("encoder", "recnet")
             for name, site in ((f"{part}.{n}", s)
                                for n, s in quantized_sites(getattr(model, part)))}
    assert len(sites) == 67
    for name, site in sites.items():
        assert tensors[f"{name}.weight_q"].dtype == torch.int8
        assert torch.equal(tensors[f"{name}.weight_q"], site.weight_q)
        assert tensors[f"{name}.weight_scale"].dtype == torch.float32
        assert tensors[f"{name}.x_scale"].dtype == torch.float32
    packed = [k for k in tensors if k.endswith("weight_packed")]
    assert len(packed) == 67 and all(tensors[k].dtype == torch.int8 for k in packed)
    for _, site in quantized_sites(base.encoder):
        site.calibration = []
    with pytest.raises(ValueError, match="armed for calibration"):
        export_embed(base)
