"""The port's bench_int8 and bench_int8_recnet on the CPU at the smallest
sizes (fp32, batch 2, one round of one call), their JSON keys against the
JAX tools', and the margin formulas of bench_int8 and bench_int8_budget
against the JAX package's, bit for bit. Every int8 tool defaults to the
card and raises without one."""

import copy
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ffrnet_tpu.models import irse as jirse
from ffrnet_tpu.models.quantize import (quantize_encoder_params,
                                        quantized_leaf_items as jax_leaf_items)
from ffrnet_tpu.tools import bench_int8_budget as jbudget
from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.models.quantize import quantize_encoder
from ffrnet_torch.tools import (bench_int8, bench_int8_budget, bench_int8_convergence,
                                bench_int8_recnet, int8_cache)

torch.set_num_threads(1)

# ffrnet_tpu/tools/bench_int8.py:126-133 (out), :155-174 (per batch), :191-194
BENCH_INT8_KEYS = {"tool", "dtype", "quant_linear", "arms", "per_batch",
                   "margin_sweep_heldout"}
PER_BATCH_KEYS = {"encoder_ms_float", "encoder_ms_int8", "speedup_dynamic",
                  "imgs_per_sec_int8", "embed_cos_mean", "embed_cos_min", "rounds_ms_float",
                  "rounds_ms_int8", "encoder_ms_int8_static", "speedup_static",
                  "imgs_per_sec_static", "embed_cos_mean_static", "embed_cos_min_static",
                  "rounds_ms_int8_static"}
SWEEP_KEYS = {"cos_mean", "cos_min"}
# ffrnet_tpu/tools/bench_int8_recnet.py:285 (out), :312, :330-342 (isolated),
# :358-359, :392-401 (pipeline)
RECNET_KEYS = {"tool", "dtype", "batch", "recnet_scales_cache", "isolated",
               "enc_scales_cache", "pipeline"}
ISOLATED_KEYS = {"cos_mean_dynamic", "cos_min_dynamic", "cos_mean_static", "cos_min_static",
                 "recnet_ms_bf16", "recnet_ms_dynamic", "recnet_ms_static", "speedup_dynamic",
                 "speedup_static"}
PIPELINE_KEYS = {"arms", "pipeline_ms_rec_bf16", "pipeline_ms_rec_int8",
                 "faces_per_sec_rec_bf16", "faces_per_sec_rec_int8", "speedup",
                 "rounds_ms_rec_bf16", "rounds_ms_rec_int8"}
MARGINS = (0.3, 0.5, 0.75, 1.0, 1.25, 1.5)
SMALL = ["--device", "cpu", "--dtype", "fp32", "--rounds", "1", "--iters", "1"]


def _run(main, argv, capsys):
    out = main(argv)
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == json.loads(json.dumps(out))
    return out


def test_bench_int8_cpu(capsys):
    out = _run(bench_int8.main, SMALL + ["--batches", "2", "--cal_batch", "2",
                                         "--margins", "0.75,1.0"], capsys)
    assert set(out) == BENCH_INT8_KEYS
    assert out["arms"] == ["bf16", "int8_dynamic", "int8_static"]
    rec = out["per_batch"]["2"]
    assert set(rec) == PER_BATCH_KEYS
    for k in ("embed_cos_mean", "embed_cos_min", "embed_cos_mean_static",
              "embed_cos_min_static"):
        assert -1.0 <= rec[k] <= 1.0 + 1e-6
    assert rec["embed_cos_min"] >= 0.99  # the JAX package's bound, tests/test_quant.py
    sweep = out["margin_sweep_heldout"]
    assert sweep["batch"] == 2 and set(sweep["margins"]) == {"0.75", "1.0"}
    for v in sweep["margins"].values():
        assert set(v) == SWEEP_KEYS and -1.0 <= v["cos_min"] <= v["cos_mean"] <= 1.0 + 1e-6
    # margin 1.0 is the static arm itself
    assert sweep["margins"]["1.0"]["cos_mean"] == rec["embed_cos_mean_static"]


def test_bench_int8_recnet_cpu(capsys, tmp_path, monkeypatch):
    monkeypatch.setattr(int8_cache, "default_cache_file", lambda: str(tmp_path / "s.json"))
    argv = SMALL + ["--batch", "2", "--cal_batch", "2"]
    out = _run(bench_int8_recnet.main, argv, capsys)
    assert set(out) == RECNET_KEYS
    assert set(out["isolated"]) == ISOLATED_KEYS
    assert set(out["pipeline"]) == {"2"} and set(out["pipeline"]["2"]) == PIPELINE_KEYS
    assert out["recnet_scales_cache"] == out["enc_scales_cache"] == int8_cache.STATUS_MISS
    iso = out["isolated"]
    for k in ("cos_mean_dynamic", "cos_min_dynamic", "cos_mean_static", "cos_min_static"):
        assert -1.0 <= iso[k] <= 1.0
    assert iso["cos_min_dynamic"] >= 0.99
    with open(tmp_path / "s.json") as f:
        assert len(json.load(f)["entries"]) == 2
    again = _run(bench_int8_recnet.main, argv + ["--skip_pipeline"], capsys)
    assert again["recnet_scales_cache"] == int8_cache.STATUS_HIT
    assert "pipeline" not in again and again["isolated"]["cos_min_static"] == iso[
        "cos_min_static"]


@pytest.fixture(scope="module")
def scaled():
    """The JAX package's quantized IR-SE50 tree and the port's int8 encoder,
    both with the same random fp32 x_scale at every site path."""
    shapes = jax.eval_shape(lambda k: quantize_encoder_params(jirse.init(k)[0]),
                            jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    paths = [p for p, _ in jax_leaf_items(tree)]
    rng = np.random.default_rng(4)
    by_path = {p: float(np.float32(v)) for p, v in zip(paths, rng.uniform(1e-4, 2.0,
                                                                          len(paths)))}
    for p, leaf in jax_leaf_items(tree):
        leaf["x_scale"] = jnp.float32(by_path[p])
    qenc = quantize_encoder(build_backbone(generator=torch.Generator().manual_seed(0)))
    return tree, int8_cache._rehydrate(qenc, by_path)


def _port_scales(model):
    return {p: s.x_scale.numpy() for p, s in int8_cache.quantized_leaf_items(model)}


@pytest.mark.parametrize("m", MARGINS)
def test_budget_margin_formula_is_the_jax_packages(scaled, m):
    tree, model = scaled
    theirs = {p: np.asarray(leaf["x_scale"]) for p, leaf in
              jax_leaf_items(jbudget._with_margin(tree, m))}
    ours = _port_scales(bench_int8_budget._with_margin(model, m))
    assert set(ours) == set(theirs)
    for p in ours:
        assert ours[p].dtype == theirs[p].dtype == np.float32
        assert ours[p].tobytes() == theirs[p].tobytes(), p


@pytest.mark.parametrize("m", MARGINS)
def test_bench_int8_margin_formula_is_the_jax_tools(scaled, m):
    """ffrnet_tpu/tools/bench_int8.py:118-124: np.float32(leaf["x_scale"] * m)
    on the host copy of the calibrated tree."""
    tree, model = scaled
    host = jax.device_get(copy.deepcopy(tree))
    theirs = {p: np.float32(leaf["x_scale"] * m) for p, leaf in jax_leaf_items(host)}
    ours = _port_scales(bench_int8.with_margin(model, m))
    for p in ours:
        assert ours[p].tobytes() == np.asarray(theirs[p]).tobytes(), p


@pytest.mark.parametrize("tool", [bench_int8, bench_int8_recnet, bench_int8_budget,
                                  bench_int8_convergence],
                         ids=lambda t: t.__name__.rsplit(".", 1)[1])
def test_tools_default_to_the_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main([])
