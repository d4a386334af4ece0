"""The port's driver (ffrnet_torch.config, ffrnet_torch.train) on the CPU:
its flag surface against ffrnet_tpu.config, the flags that raise, and full
runs from files (cadence, resume, the non-finite abort, preemption, eval,
--phase test) with a small stand-in for the frozen IR-SE50, so that a step
costs well under a second (the real encoder runs in
tests/test_torch_driver_parity.py)."""

import dataclasses
import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch

from ffrnet_torch import train as train_mod
from ffrnet_torch.checkpoint.store import load_checkpoint
from ffrnet_torch.config import Options, parse_args
from ffrnet_torch.models.recnet import SS_KERNEL_CONFIG, RecNetConfig
from ffrnet_tpu.config import parse_args as j_parse_args

torch.set_num_threads(1)

ARGVS = [
    [],
    ["--phase", "test", "--batch_size", "16", "--total_epochs", "3", "--model_name",
     "FFR-Net", "--optimizer", "Adam", "--lr", "0.1", "--beta1", "0.9", "--momentum", "0.9",
     "--weight_decay", "0", "--loss_weight", "1", "1", "1", "1", "--print_freq", "100",
     "--save_freq", "4000", "--eval_freq", "1000", "--continue_train", "0", "--which_file",
     "latest", "--other", "train", "--debug", "0", "--train_data", "x", "--seed", "5",
     "--nThread", "2"],
    ["--ss_impl", "pallas", "--compute_dtype", "bf16", "--remat", "1", "--cache_features",
     "1", "--pack_upload", "1", "--host_normalize", "1", "--feature_cache_dir", "/c",
     "--optimizer", "sgd", "--nesterov", "1", "--loss_weight", "1", "0.5", "2", "0",
     "--faithful_ce_weight", "0", "--faithful_eval_flip", "1", "--num_classes", "100",
     "--mesh_data", "1", "--report_roc", "1", "--save_wrong", "1", "--recnet_weights", "r.pth",
     "--encoder_weights", "e.pth", "--test_pair_list", "p.txt", "--test_data", "/lfw"],
]


def fields(opts):
    d = dataclasses.asdict(opts)
    d.pop("device", None)
    d["config_string"] = "\n".join(line for line in d["config_string"].splitlines()
                                   if not line.startswith("device:"))
    return d


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "reference_flags", "options"])
def test_flag_surface_matches_jax(argv, tmp_path):
    argv = argv + ["--weight_root", str(tmp_path / "w")]
    opts = parse_args(argv)
    jopts = j_parse_args(argv, make_dirs=False)
    assert fields(opts) == fields(jopts)
    assert opts.device == "cuda"
    assert parse_args(argv + ["--device", "cpu"], make_dirs=False).device == "cpu"
    with open(os.path.join(opts.ckpt_dir, "opt.txt")) as f:
        assert f.read() == opts.config_string + "\n"
    for d in ("visuals", "test", "val"):
        assert os.path.isdir(os.path.join(opts.ckpt_dir, d))
    assert os.path.isdir(opts.log_dir)

    cfg, jcfg = opts.trainer_config(), jopts.trainer_config()
    for f in dataclasses.fields(cfg):
        if f.name != "recnet":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    base = SS_KERNEL_CONFIG if opts.ss_impl == "pallas" else RecNetConfig()
    assert cfg.recnet == dataclasses.replace(base, num_classes=opts.num_classes)


@pytest.mark.parametrize("argv,item", [
    (["--mesh_data", "2"], "needs 2 devices but only 1"),
    (["--mesh_model", "2"], "exceeds the 1 visible devices"),
    (["--ckpt_backend", "orbax"], None), (["--ss_impl", "triton"], "ss_impl")])
def test_unported_flags_raise(argv, item):
    """--mesh_data and --mesh_model parse, and a mesh axis larger than the
    world (one process here) raises make_mesh's message, the JAX package's;
    --ckpt_backend orbax parses and builds the one-process mesh; an
    unknown --ss_impl raises at parsing."""
    if item is None:
        opts = parse_args(argv, make_dirs=False)
        assert opts.ckpt_backend == "orbax"
        assert train_mod.parallel.mesh_axes(train_mod.make_train_mesh(opts)) == {
            "data": 1, "model": 1}
        return
    with pytest.raises(ValueError, match=item):
        opts = parse_args(argv, make_dirs=False)
        train_mod.make_train_mesh(opts)


class StandIn(torch.nn.Module):
    """A stand-in for the frozen IR-SE50: one 16x16/16 convolution to the
    (N, 512, 7, 7) map and its normalized mean as the embedding."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.input_layer = torch.nn.Sequential(torch.nn.Conv2d(3, 512, 16, stride=16))
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)

    def forward(self, x):
        fm = self.input_layer(x)
        return fm, torch.nn.functional.normalize(fm.mean((2, 3)), dim=1)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(train_mod, "load_encoder",
                        lambda opts, device: StandIn().to(device).eval())


@pytest.fixture(scope="module")
def lfw20(tmp_path_factory):
    """An LFW tree with masked twins and a 20-pair list (2 pairs per fold)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("lfw") / "lfw"
    for i in range(4):
        d = root / f"P_{i}"
        d.mkdir(parents=True)
        for k in (1, 2):
            img = rng.integers(0, 256, (112, 112, 3), dtype=np.uint8)
            Image.fromarray(img).save(d / f"P_{i}_{k:04}.jpg")
            Image.fromarray(img // 3).save(d / f"P_{i}_{k:04}_m.jpg")
    lines = ["20\n"]
    for k in range(10):
        lines.append(f"P_{k % 4}\t1\t2\n")
        lines.append(f"P_{k % 4}\t1\tP_{(k + 1) % 4}\t2\n")
    pairs = root / "pairs.txt"
    pairs.write_text("".join(lines))
    return str(root), str(pairs)


def run_opts(root, lfw=None, **kw):
    base = dict(phase="train", train_data="synthetic", num_classes=4, batch_size=4,
                total_epochs=2, optimizer="adam", lr=1e-3, save_freq=2, print_freq=3,
                eval_freq=0, n_thread=2, seed=0, weight_root=str(root), device="cpu")
    if lfw is not None:
        base.update(test_data=lfw[0], test_pair_list=lfw[1])
    base.update(kw)
    return Options(**base).finalize()


@pytest.fixture(scope="module")
def full_run(tmp_path_factory, lfw20):
    """One uninterrupted run: 16 synthetic samples, batch 4, 2 epochs = 8
    steps, numbered checkpoints every 2, eval every 4."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_mod, "load_encoder", lambda opts, device: StandIn().to(device).eval())
        opts = run_opts(tmp_path_factory.mktemp("w1"), lfw20, eval_freq=4)
        train_mod.train(opts)
    return opts


def test_cadence_files_and_meta(full_run):
    names = sorted(os.listdir(full_run.ckpt_dir))
    ckpts = [n for n in names if n.endswith(".pth.gzip")]
    assert ckpts == ["0000002.pth.gzip", "0000004.pth.gzip", "0000006.pth.gzip",
                     "0000008.pth.gzip", "latest.pth.gzip"]
    assert not [n for n in names if n.startswith(".")]  # no tmp files left
    for name, meta in (("0000004", {"epoch": 0, "iter": 4}), ("0000006", {"epoch": 1, "iter": 6}),
                       ("latest", {"epoch": 1, "iter": 8})):
        assert load_checkpoint(full_run.ckpt_dir, name)[2] == meta
    with open(os.path.join(full_run.log_dir, full_run.save_weight_dir,
                           "all_scalars.json")) as f:
        scalars = json.load(f)
    assert scalars["train_values/TotalLoss"]["iters"] == list(range(1, 9))
    assert np.isfinite(scalars["train_values/TotalLoss"]["values"]).all()
    for ocl in range(3):  # the eval at iterations 4 and 8 covered ocl 0/1/2
        for k in ("acc", "acc_new"):
            s = scalars[f"test_acc/ocl{ocl}/{k}"]
            assert s["iters"] == [4, 8] and all(0 <= v <= 1 for v in s["values"])


def test_resume_mid_epoch_is_bit_equal(full_run, lfw20, stand_in, tmp_path):
    """Resumed from 0000006 (epoch 1, in-epoch offset 2) in a fresh root,
    the run trains steps 7 and 8 and ends bit-equal to the uninterrupted
    run (which evaluated at step 4 in between): parameters, BN stats,
    optimizer state and step count."""
    opts = run_opts(tmp_path / "w2", lfw20, eval_freq=4, continue_train=1,
                    which_file="0000006")
    shutil.copy(os.path.join(full_run.ckpt_dir, "0000006.pth.gzip"), opts.ckpt_dir)
    train_mod.train(opts)
    assert load_checkpoint(opts.ckpt_dir, "latest")[2] == {"epoch": 1, "iter": 8}
    sd, opt, _ = load_checkpoint(opts.ckpt_dir, "0000008")
    want_sd, want_opt, _ = load_checkpoint(full_run.ckpt_dir, "0000008")
    assert sd.keys() == want_sd.keys()
    for k, v in want_sd.items():
        assert torch.equal(sd[k], v), k
    assert opt.keys() == want_opt.keys()
    for key, st in want_opt.items():
        for entry, v in st.items():
            assert torch.equal(opt[key][entry], v), (key, entry)


def test_non_finite_loss_aborts_before_any_checkpoint(stand_in, tmp_path):
    opts = run_opts(tmp_path / "w", num_classes=8, batch_size=4, total_epochs=1,
                    optimizer="sgd", lr=1e30, save_freq=1, print_freq=1000)
    with pytest.raises(FloatingPointError, match="non-finite loss at iter"):
        train_mod.train(opts)
    names = [n for n in os.listdir(opts.ckpt_dir) if n.endswith(".pth.gzip")]
    assert names, "expected a checkpoint before the abort"
    for n in names:
        sd, _, _ = load_checkpoint(opts.ckpt_dir, n)
        for k, v in sd.items():
            assert torch.isfinite(v.float()).all(), (n, k)


def test_preemption_by_flag_and_uninstall(stand_in, tmp_path, monkeypatch):
    real_step, calls = train_mod.train_step, []

    def step_then_preempt(*args, **kw):
        calls.append(1)
        if len(calls) == 3:
            train_mod.preemption_guard.requested = True
        return real_step(*args, **kw)

    monkeypatch.setattr(train_mod, "train_step", step_then_preempt)
    before = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGUSR1)
    opts = run_opts(tmp_path / "w", total_epochs=50, save_freq=10 ** 6, print_freq=10 ** 6)
    train_mod.train(opts)  # returns after step 3 in place of 50 epochs
    assert len(calls) == 3
    assert load_checkpoint(opts.ckpt_dir, "latest")[2] == {"epoch": 0, "iter": 3}
    _, opt, _ = load_checkpoint(opts.ckpt_dir, "latest")
    assert opt and all("exp_avg" in st for st in opt.values())
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGUSR1)) == before

    g = train_mod.PreemptionGuard().install()
    assert signal.getsignal(signal.SIGTERM) == g._handler
    g.uninstall()
    g.uninstall()  # idempotent
    assert signal.getsignal(signal.SIGTERM) == before[0]


def test_eval_restores_train_mode_when_it_raises(lfw20, monkeypatch):
    from ffrnet_torch.models.recnet import build_recnet

    rec = build_recnet(RecNetConfig(num_classes=4), generator=torch.Generator().manual_seed(0))
    rec.train()

    def boom(*a, **kw):
        assert not rec.training  # eval runs in eval mode
        raise RuntimeError("eval failed")

    monkeypatch.setattr(train_mod, "evaluate_pairs", boom)
    opts = Options(test_data=lfw20[0], test_pair_list=lfw20[1], n_thread=2,
                   batch_size=4).finalize(make_dirs=False)
    with pytest.raises(RuntimeError, match="eval failed"):
        train_mod.eval_lfw(opts, StandIn().eval(), rec, 1)
    assert rec.training


def test_phase_test_writes_roc_and_wrong_pairs(full_run, lfw20, stand_in, tmp_path):
    argv = ["--phase", "test", "--device", "cpu", "--num_classes", "4", "--batch_size", "8",
            "--nThread", "2", "--test_data", lfw20[0], "--test_pair_list", lfw20[1],
            "--weight_root", str(tmp_path / "w"), "--report_roc", "1", "--save_wrong", "1"]
    opts = parse_args(argv, make_dirs=False)
    os.makedirs(opts.ckpt_dir)
    shutil.copy(os.path.join(full_run.ckpt_dir, "0000008.pth.gzip"), opts.ckpt_dir)
    train_mod.main(argv)
    with open(os.path.join(opts.log_dir, opts.save_weight_dir, "all_scalars.json")) as f:
        scalars = json.load(f)
    for ocl in range(3):
        for kind in ("new", "raw"):
            for m in ("eer", "auc", "tar@far0.001", "tar@far0.01", "tar@far0.1"):
                assert f"test_roc_{kind}/ocl{ocl}/{m}" in scalars
        assert f"test_acc_new/ocl{ocl}/acc_new" in scalars
        accs = [scalars[f"test_acc/ocl{ocl}/acc"]["values"][0],
                scalars[f"test_acc_new/ocl{ocl}/acc_new"]["values"][0]]
        for sub, acc in zip(("wrong_images", "wrong_images_new"), accs):
            d = os.path.join(opts.ckpt_dir, f"{sub}_ocl{ocl}")
            # each misclassified pair of the 20 as two PNGs
            assert len(os.listdir(d)) == 2 * round(20 * (1 - acc)), (d, acc)


def test_eval_extras_match_jax(lfw20, tmp_path):
    """roc_curve, verification_from_embeddings, process_pair_slice and
    save_wrong_images against ffrnet_tpu's on the same inputs."""
    import jax.numpy as jnp

    from ffrnet_torch.data.datasets import LfwPairs
    from ffrnet_torch.eval import lfw as P
    from ffrnet_torch.eval import runner as R
    from ffrnet_tpu.eval import lfw as J
    from ffrnet_tpu.eval import runner as JR

    rng = np.random.default_rng(8)
    f = rng.standard_normal((4, 60, 32)).astype(np.float32)
    labels = rng.integers(0, 2, 60).astype(np.int32)
    scores = (rng.uniform(-1, 1, 60) // 0.005 * 0.005).astype(np.float32)  # on the grid
    for a, b in zip(P.roc_curve(torch.from_numpy(scores), torch.from_numpy(labels)),
                    J.roc_curve(jnp.asarray(scores), jnp.asarray(labels))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = P.verification_from_embeddings(*map(torch.from_numpy, f), torch.from_numpy(labels))
    want = J.verification_from_embeddings(*map(jnp.asarray, f), jnp.asarray(labels))
    for r, jr in zip(got, want):
        for k in ("mean_accuracy", "fold_accuracies", "best_thresholds"):
            np.testing.assert_array_equal(getattr(r, k).numpy(), np.asarray(getattr(jr, k)))
    for n, p in ((6000, 4), (7, 3), (2, 5)):
        assert [R.process_pair_slice(n, i, p) for i in range(p)] == \
            [JR.process_pair_slice(n, i, p) for i in range(p)]
    for host_normalize in (False, True):
        ds = LfwPairs(*lfw20, test_ocl_num=1, flip_prob=0.0, host_normalize=host_normalize)
        d, jd = tmp_path / f"p{host_normalize}", tmp_path / f"j{host_normalize}"
        assert R.save_wrong_images(ds, [3, 0], str(d)) == JR.save_wrong_images(ds, [3, 0],
                                                                              str(jd)) == 4
        for name in sorted(os.listdir(jd)):
            assert (d / name).read_bytes() == (jd / name).read_bytes(), name


def test_maybe_trace_and_annotate(tmp_path, monkeypatch):
    from ffrnet_torch.utils.profiling import annotate, maybe_trace

    monkeypatch.delenv("FFRNET_TRACE_DIR", raising=False)
    with maybe_trace(None):  # no directory: no trace
        with annotate("idle"):
            pass
    monkeypatch.setenv("FFRNET_TRACE_DIR", str(tmp_path / "trace"))
    with maybe_trace():
        with annotate("ffrnet_step"):
            torch.ones(8).sum()
    assert "ffrnet_step" in (tmp_path / "trace" / "trace.json").read_text()


def test_cached_packed_run_matches_the_raw_run(lfw20, stand_in, tmp_path):
    """--cache_features 1 --pack_upload 1 (features cached once, both
    streams of a batch in one upload) trains as the raw-image run does:
    the same flips, the same updates."""
    root = lfw20[0]
    lst = tmp_path / "list.txt"
    lst.write_text("".join(f"P_{i}/P_{i}_{k:04}.jpg {i}\n" for i in range(4) for k in (1, 2)))
    kw = dict(train_data=root, train_img_list=str(lst), optimizer="sgd", lr=1e-2,
              momentum=0.0, save_freq=4, print_freq=1000)
    raw = run_opts(tmp_path / "raw", **kw)
    cached = run_opts(tmp_path / "cached", cache_features=1, pack_upload=1, **kw)
    for opts in (raw, cached):
        train_mod.train(opts)
    assert os.path.exists(os.path.join(cached.ckpt_dir, "feature_cache", "meta.json"))
    got, _, meta = load_checkpoint(cached.ckpt_dir, "0000004")
    want, _, _ = load_checkpoint(raw.ckpt_dir, "0000004")
    assert meta == {"epoch": 1, "iter": 4}
    for k, v in want.items():
        if v.is_floating_point():
            torch.testing.assert_close(got[k], v, atol=1e-6, rtol=0, msg=k)


class _Counted(torch.nn.Module):
    """A StandIn that counts its forwards (the step's or the eval's encoder)."""

    def __init__(self, inner):
        super().__init__()
        self.inner, self.calls = inner, 0
        self.input_layer = inner.input_layer

    def forward(self, x):
        self.calls += 1
        return self.inner(x)


@pytest.mark.parametrize("cache", [0, 1])
def test_int8_encoder_flag_reaches_the_step_and_the_cache(cache, lfw20, tmp_path, monkeypatch):
    """--int8_encoder 1 (ffrnet_tpu/train.py:452-482, :552-558): parsed and
    accepted; prepare_int8_encoder gets the float encoder, the training set
    and the compute type; its encoder runs every step's frozen forward, or
    the feature-cache build (made only when a build is needed), while LFW
    eval runs the float encoder; an int8-built cache's fingerprint differs
    from a float-built one's. prepare_int8_encoder itself runs on the real
    IR-SE50 in tests/test_torch_int8_model.py."""
    opts = parse_args(["--int8_encoder", "1", "--weight_root", str(tmp_path / "p")],
                      make_dirs=False)
    assert opts.int8_encoder == 1
    made = []

    def load(opts, device):
        made.append(_Counted(StandIn().to(device).eval()))
        return made[-1]

    calls = []

    def prepare(encoder, dataset, compute_dtype):
        calls.append((encoder, len(dataset), compute_dtype))
        made.append(_Counted(StandIn().eval()))
        return made[-1]

    monkeypatch.setattr(train_mod, "load_encoder", load)
    monkeypatch.setattr(train_mod, "prepare_int8_encoder", prepare)
    cache_dir = str(tmp_path / "cache")
    kw = dict(save_freq=4, print_freq=1000, total_epochs=1,
              cache_features=cache, feature_cache_dir=cache_dir if cache else "")
    train_mod.train(run_opts(tmp_path / "int8", None if cache else lfw20, int8_encoder=1,
                             eval_freq=4, **kw))
    float_enc, int8_enc = made
    assert calls == [(float_enc, 16, "fp32")]
    assert int8_enc.calls == (8 if cache else 4)  # 4 batches: 2 flips each, or 4 steps
    # eval at step 4 (the raw-image run): ocl 0/1/2, 20 pairs in batches of 4
    assert float_enc.calls == (0 if cache else 3 * 5)
    if cache:
        from ffrnet_torch.training.feature_cache import build_feature_cache, cache_fingerprint

        with open(os.path.join(cache_dir, "meta.json")) as f:
            fp_int8 = json.load(f)["fingerprint"]
        ds = train_mod.make_train_dataset(run_opts(tmp_path / "ds"))
        assert fp_int8 == cache_fingerprint(ds, float_enc, "int8-static-v1")
        assert fp_int8 != cache_fingerprint(ds, float_enc)  # the float build's

        def unexpected():
            raise AssertionError("a complete cache needs no encoder")

        build_feature_cache(ds, float_enc, cache_dir, batch_size=4, encoder_factory=unexpected,
                            fingerprint_extra="int8-static-v1")

