"""How the reference computes its convolutions and Linears.

`Numerics` is handed to every forward of the reference. Each conv or
Linear asks it for its product by the site's state-dict path (the paths of
the original FFR-Net checkpoints, e.g. `body.3.res_layer.1`). A site
listed in `sites` computes on quantized operands; every other one in plain
float32.

Quantization, symmetric with round half to even and a clip at +-qmax
(qmax = 2^(bits-1) - 1):
  weights      per output channel (axis 0): scale = max(amax, 1e-12) / qmax,
               from `weight_round`'s copy of the weight (float32, or the
               bf16 value a bf16 model serves)
  activations  per tensor: this batch's max|x| (until calibrated), or a scale
               calibrated once (`calibrate`): max over the calibration
               batches of the site input's max|x|, times `margin`, / qmax
The product is taken on the dequantized operands in float32: the same
number as the integer product scaled, up to float32 rounding.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

EPS = 1e-12


def qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def quant_weight(w, bits: int):
    """Dequantized per-output-channel copy of w."""
    amax = w.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True)
    scale = amax.clamp_min(EPS) / qmax(bits)
    return torch.clamp(torch.round(w / scale), -qmax(bits), qmax(bits)) * scale


def quant_act(x, scale, bits: int):
    return torch.clamp(torch.round(x / scale), -qmax(bits), qmax(bits)) * scale


class Numerics:
    """sites: None (every conv and Linear) or a set of site paths that
    compute quantized; bits 0 means no site is quantized (plain float32).
    Activation scales are per batch until `calibrate` bakes static ones."""

    def __init__(self, bits: int = 0, sites=None, weight_round: str = "fp32",
                 margin: float = 1.0):
        self.bits, self.sites, self.static = bits, sites, False
        self.weight_round, self.margin = weight_round, margin
        self.scales = {}          # site -> calibrated activation scale
        self._records = None      # site -> amaxes while calibrating
        self._weights = {}        # site -> dequantized weight

    def quantized(self, name: str) -> bool:
        return self.bits > 0 and (self.sites is None or name in self.sites)

    def _weight(self, name, w):
        q = self._weights.get(name)
        if q is None:
            src = w.bfloat16().float() if self.weight_round == "bf16" else w
            q = self._weights[name] = quant_weight(src, self.bits)
        return q

    def _act(self, name, x):
        if self._records is not None:  # calibrating: plain input, dequantized weights
            self._records.setdefault(name, []).append(float(x.abs().amax()))
            return x
        if self.static:
            return quant_act(x, self.scales[name], self.bits)
        return quant_act(x, x.abs().amax().clamp_min(EPS) / qmax(self.bits), self.bits)

    def conv(self, name, x, w, b=None, stride=1, padding=0):
        if self.quantized(name):
            x, w = self._act(name, x), self._weight(name, w)
        return F.conv2d(x, w, b, stride=stride, padding=padding)

    def linear(self, name, x, w, b=None):
        if self.quantized(name):
            x, w = self._act(name, x), self._weight(name, w)
        return F.linear(x, w, b)

    @torch.no_grad()
    def calibrate(self, run, batches) -> "Numerics":
        """Bake static scales: run(x) over every batch with the sites
        recording their inputs' max|x|."""
        self._records = {}
        try:
            for x in batches:
                run(x)
        finally:
            records, self._records = self._records, None
        for name, amaxes in records.items():
            self.scales[name] = torch.tensor(
                max(max(amaxes), EPS) * self.margin / qmax(self.bits), dtype=torch.float32)
        self.static = True
        return self


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuDNN's and cuBLAS's float32 products in TF32 (the control of a
    float32 cell) or in float32, restored after the block."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
