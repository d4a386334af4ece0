"""The reference's embeddings of a configuration: weights from the seed,
numerics from the configuration (or a control's lower precision)."""

from __future__ import annotations

import torch

from benchmarks.reference import irse, recnet
from benchmarks.reference.numerics import Numerics


def unit_range(u8):
    """uint8 pixels -> float32 [-1, 1]: (x / 255 - 0.5) / 0.5."""
    return (u8.float() / 255.0 - 0.5) / 0.5


class Reference:
    """IR-SE50 from `seed`, RecNet from `seed + 1`, on `device`, float32.

    precision: "fp32" computes the configuration as stated (its int8
    sites at 8 bits with static scales from `cal_faces`); "int8" every conv
    and Linear at 8 bits, activation scales per batch (the control of a
    float configuration); "int4" the configuration's int8 sites at 4 bits
    (the control of an int8 configuration). `dtype`: the type the
    program serves the weights in, which its int8 sites quantize."""

    def __init__(self, config, seed, device, precision="fp32", cal_faces=None,
                 dtype="bf16"):
        q = config.get("int8")
        enc = irse.init_params(seed, device)
        if (q and q["fold_bn"]) or config.get("fold_bn"):
            enc = irse.fold_bn(enc)
        self.enc = enc
        self.rec = recnet.init_params(seed + 1, config["recnet"]["num_classes"], device)
        self.device = device
        if precision == "int8" and q is None:
            self.num_enc = Numerics(bits=8)
            self.num_rec = Numerics(bits=8)
        elif q is not None:
            if q["quantize"] not in ("encoder", True):
                raise ValueError(f"reference: int8 sites {q['quantize']!r} not modelled")
            bits = {"fp32": 8, "int4": 4}[precision]
            self.num_enc = Numerics(bits=bits, sites=irse.INT8_SITES, weight_round=dtype,
                                    margin=q["margin"])
            x = self.nchw(unit_range(torch.as_tensor(cal_faces).to(device)))
            self.num_enc.calibrate(lambda b: irse.forward(self.enc, b, self.num_enc), [x])
            self.num_rec = Numerics()
        elif precision == "fp32":
            self.num_enc = self.num_rec = Numerics()
        else:
            raise ValueError(f"reference: no precision {precision!r} for this configuration")

    @staticmethod
    def nchw(x_nhwc):
        return x_nhwc.permute(0, 3, 1, 2).contiguous()

    @torch.no_grad()
    def embed(self, x_unit_nhwc):
        """(N, 112, 112, 3) BGR [-1, 1] float32 -> (raw, rectified)."""
        featmap, raw = irse.forward(self.enc, self.nchw(x_unit_nhwc), self.num_enc)
        rect = recnet.forward(self.rec, featmap, self.num_rec)["feat_new_v"]
        return raw, rect
