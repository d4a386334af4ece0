"""The port's quickstarts (ffrnet_torch.examples) and its serving bench
(ffrnet_torch.tools.bench_serving), run in-process on the CPU as
tests/test_examples.py runs examples/; the quickstarts and the eval and
driver benches default to the card."""

import runpy
import sys

import pytest
import torch

torch.set_num_threads(1)


def _run(module, argv):
    old_argv = sys.argv
    sys.argv = [module] + argv
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=False)
    finally:
        sys.argv = old_argv


def test_embed_and_verify_example(capsys):
    _run("ffrnet_torch.examples.embed_and_verify", ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "(no weights given: random init" in out
    assert "raw embeddings (8, 512), rectified (8, 512)" in out
    assert "pair scores:" in out


@pytest.fixture
def tiny_service(monkeypatch):
    """One 16-bucket in place of max_batch=256's ladder: the same pad ->
    dispatch -> slice path at a CPU test's cost (tests/test_examples.py)."""
    from ffrnet_torch.serving import service as svc_mod

    orig = svc_mod.EmbeddingService.__init__

    def tiny(self, model, max_batch=256, **kw):
        kw.pop("buckets", None)
        orig(self, model, max_batch=16, buckets=(16,), **kw)

    monkeypatch.setattr(svc_mod.EmbeddingService, "__init__", tiny)


def test_serve_http_example(tiny_service, monkeypatch, capsys):
    """Startup (warmup, HTTP bind on a free port) and the clean shutdown
    after a Ctrl-C, simulated in the example's wait."""
    import time as time_mod

    def fake_sleep(_):
        raise KeyboardInterrupt

    monkeypatch.setattr(time_mod, "sleep", fake_sleep)
    _run("ffrnet_torch.examples.serve_http", ["0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "serving on :" in out
    assert "served 0 faces in 0 dispatches" in out


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for module in ("ffrnet_torch.examples.embed_and_verify", "ffrnet_torch.examples.serve_http",
                   "ffrnet_torch.examples.int8_serving", "ffrnet_torch.examples.train_synthetic",
                   "ffrnet_torch.tools.bench_eval", "ffrnet_torch.tools.bench_driver"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _run(module, [])


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_bench_serving_smoke(wire, capsys):
    from ffrnet_torch.tools import bench_serving

    out = bench_serving.main(["--device", "cpu", "--clients", "2", "--group", "2",
                              "--seconds", "0.5", "--max_batch", "4", "--buckets", "4",
                              "--dtype", "fp32", "--wire", wire])
    assert out["metric"] == "served_faces_per_sec" and out["device"] == "cpu"
    assert out["value"] > 0 and out["dispatches"] >= 1 and out["client_errors"] == 0
    assert out["latency_ms_p50"] is not None and out["wire"] == wire
    assert 0 <= out["padded_frac"] < 1
    assert set(out) == {"metric", "value", "unit", "clients", "group", "requests",
                        "latency_ms_p50", "latency_ms_p99", "client_errors", "dispatches",
                        "mean_batch", "padded_frac", "wire", "encoder", "device"}


@pytest.mark.parametrize("encoder", ["int8", "int8_static", "int8_all"])
def test_bench_serving_int8_arms(encoder, capsys, monkeypatch):
    """The int8 arms (ffrnet_tpu/tools/bench_serving.py:61-68): BN folded,
    the encoder int8 (int8_all: RecNet's conv chains too), static scales
    calibrated for int8_static and int8_all; faces served without errors."""
    from ffrnet_torch.api import FFRNet
    from ffrnet_torch.ops.quant import has_int8_sites
    from ffrnet_torch.tools import bench_serving

    served = []
    embed = FFRNet.embed

    def spy(self, images):
        served.append(self)
        return embed(self, images)

    monkeypatch.setattr(FFRNet, "embed", spy)
    out = bench_serving.main(["--device", "cpu", "--clients", "2", "--group", "2",
                              "--seconds", "0.3", "--max_batch", "4", "--buckets", "4",
                              "--dtype", "fp32", "--encoder", encoder])
    assert out["encoder"] == encoder and out["value"] > 0 and out["client_errors"] == 0
    model = served[-1]
    sites = [m for m in model.encoder.modules() if type(m).__name__ == "Int8Site"]
    assert len(sites) == 52 and has_int8_sites(model.recnet) == (encoder == "int8_all")
    assert all((s.x_scale is None) == (encoder == "int8") for s in sites)
    assert model.encoder.body[0].res_layer[3].bias is not None  # folded


def test_int8_serving_example(monkeypatch, capsys):
    """Calibration, warmup and one request of 8 faces, through one bucket of
    8 (the float64 twin makes a CPU int8 embed slow)."""
    from ffrnet_torch.serving import service as svc_mod

    orig = svc_mod.EmbeddingService.__init__

    def one_bucket(self, model, max_batch=256, **kw):
        orig(self, model, max_batch=8, buckets=(8,), **kw)

    monkeypatch.setattr(svc_mod.EmbeddingService, "__init__", one_bucket)
    _run("ffrnet_torch.examples.int8_serving", ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "int8 embeddings: raw (8, 512) rectified (8, 512)" in out
