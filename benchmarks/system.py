"""The system under test, built from a configuration file and the seed,
and what the traffic drivers share.

Only this module, the drivers (`benchmarks/traffic/<kind>.py`) and the
harness's kernel build import the program (`ffrnet_torch`); the reference
(`benchmarks/reference/`) never does.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmarks.reference import irse, recnet

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
ITEMSIZE = {"fp32": 4, "bf16": 2}


def stream(seed: int, k: int) -> int:
    """A 63-bit seed for the k-th stream of draws of a run's seed."""
    return int(np.random.SeedSequence([seed % 2 ** 63, k]).generate_state(1, np.uint64)[0]
               % 2 ** 63)


# the streams of draws a run's seed gives, by use
STREAM_TRAFFIC, STREAM_LANDMARKS, STREAM_CALIBRATION, STREAM_SAMPLE, STREAM_LABELS = 1, 2, 3, 4, 5


def uint8_images(shape, seed: int, k: int, device) -> torch.Tensor:
    """Uniform uint8 pixels drawn on `device` from stream k of `seed`."""
    g = torch.Generator(device=device).manual_seed(stream(seed, k))
    return torch.randint(0, 256, shape, dtype=torch.uint8, generator=g, device=device)


def recnet_config(config: dict):
    from ffrnet_torch.models.recnet import RecNetConfig

    return RecNetConfig(**config["recnet"])


def check_encoder(config: dict) -> None:
    """FFRNet builds IR-SE50 (ir_se, 112x112, 512-d); refuse anything else."""
    enc = config["encoder"]
    want = {"num_layers": 50, "mode": "ir_se", "input_size": 112, "embedding": 512}
    got = {k: enc[k] for k in want}
    if got != want:
        raise SystemExit(f"benchmark: the encoder {got} is not the IR-SE50 FFRNet builds")


def loaded(module, params: dict):
    """`module`, built empty by the program, holding the benchmark's
    weights `params` (the reference's, from the same seed); its BNs' batch
    counts at 0."""
    missing, unexpected = module.load_state_dict(params, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise SystemExit(f"benchmark: the reference's weights do not fit the program's "
                         f"{type(module).__name__}: missing {missing}, unexpected {unexpected}")
    with torch.no_grad():
        for key, buf in module.named_buffers():
            if key.endswith("num_batches_tracked"):
                buf.zero_()
    return module


def encoder(config: dict, seed: int, device):
    """The program's IR-SE50 (eval mode) with the weights drawn from `seed`."""
    from ffrnet_torch.models.irse import build_backbone

    check_encoder(config)
    return loaded(build_backbone(device=device), irse.init_params(seed, device))


def recnet_weights(config: dict, seed: int, device) -> dict:
    """RecNet's weights drawn from `seed + 1`."""
    return recnet.init_params(seed + 1, config["recnet"]["num_classes"], device)


def serving_model(config: dict, dtype: str, seed: int, device, cal_faces=None):
    """FFR-Net with the weights drawn from the seed (the encoder from
    `seed`, RecNet from `seed + 1`), prepared as the configuration serves
    it: float in `dtype`, or BN-folded, cast and int8-quantized, then
    calibrated on `cal_faces` (host uint8)."""
    from ffrnet_torch.api import FFRNet
    from ffrnet_torch.models.recnet import build_recnet

    cfg = recnet_config(config)
    rec = loaded(build_recnet(cfg, device=device), recnet_weights(config, seed, device))
    model = FFRNet(encoder(config, seed, device), rec, cfg, device)
    q = config.get("int8")
    if q is None:
        return model.prepare(fold_bn=config.get("fold_bn", False), dtype=DTYPES[dtype])
    model = model.prepare(fold_bn=q["fold_bn"], dtype=DTYPES[dtype],
                          quantize_int8=q["quantize"])
    return model.calibrate_int8([cal_faces], margin=q["margin"])


class DriverBase:
    """What every traffic driver shares: the run, the pool index of call i,
    the synchronize that closes the window and the freeing of state."""

    def __init__(self, run):
        self.run = run
        self.spec = run.spec
        self.traffic = run.spec.traffic
        self.dev = run.device
        self.span = run.spans

    def instrumented(self):
        """Ranges around program functions, opened in traced runs only."""
        return contextlib.nullcontext()

    def after_window(self):
        """Once the window has closed, before the peak memory is read: what
        the check needs of the program's state as the window left it."""

    def finish(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def release(self):
        """Free the program's state before the reference runs."""
        for name in self.program_state:
            setattr(self, name, None)

    program_state = ()


@contextlib.contextmanager
def ranged(module, names, label):
    """Within the block, module.<name> for each of `names` runs inside a
    profiler range `label` (traced runs only; nothing else changes)."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(fn):
        def call(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return call

    for n, fn in saved.items():
        setattr(module, n, wrap(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def cosine_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per row, 1 - cos(a, b), in float64."""
    a, b = a.double(), b.double()
    return 1.0 - (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))
