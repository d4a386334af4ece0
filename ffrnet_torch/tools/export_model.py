"""Export the inference graph as a torch.export program (`.pt2`).

Counterpart of ffrnet_tpu/tools/export_model.py. `torch.export` traces
`FFRNet`'s inference forward (`api.forward_nhwc`: frozen IR-SE50 ->
RecNet -> raw and rectified embeddings) into one ExportedProgram with the
weights in it, and `torch.export.save` writes it to one file. The batch
dimension is symbolic ("b", from 1 up), so one program serves every batch
size, a single face included.

The program holds the port's kernels as operators: 24 `ffrnet.se_gating`,
one `ffrnet.channel_branch` (the fused RecNet) or one
`ffrnet.self_similarity` (`SS_KERNEL_CONFIG`), and one `ffrnet.int8_conv`
per int8 site. It takes aligned faces, so no warp is on its path.

Unlike a StableHLO artifact, a `.pt2` file is not self-contained: loading
it needs the `ffrnet::` operators registered, so

    import torch
    import ffrnet_torch.ops.kernels  # registers the ffrnet:: operators
    program = torch.export.load("ffrnet.pt2")
    raw, rect = program.module()(images)  # (b, 112, 112, 3) in its dtype

and it is tied to the PyTorch version that wrote it.

    python -m ffrnet_torch.tools.export_model --out ffrnet.pt2 \\
        [--encoder se50.pth --recnet FFRNet.pth] [--dtype bf16] \\
        [--static_batch N] [--device cuda|cpu]

The default device is the card, and the tool raises without one; `--device
cpu` exports and checks on the CPU (the twins run there). A round trip
(save, load, one call against `FFRNet.embed`) is built in.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
from torch import nn

from ffrnet_torch.api import FFRNet, forward_nhwc, resolve_device
from ffrnet_torch.models.quantize import quantized_sites

# torch.export specializes sizes 0 and 1: a symbolic batch is traced at 2
TRACE_BATCH = 2


class EmbedModule(nn.Module):
    """`FFRNet`'s inference forward as a module: (b, 112, 112, 3) NHWC
    images in the model's dtype -> (raw (b, 512), rectified (b, 512))."""

    def __init__(self, model: FFRNet):
        super().__init__()
        self.encoder, self.recnet, self.dtype = model.encoder, model.recnet, model.dtype

    def forward(self, images):
        raw, rect, _ = forward_nhwc(self.encoder, self.recnet, self.dtype, images)
        return raw, rect


def export_embed(model: FFRNet, *, symbolic_batch: bool = True, static_batch: int = 8):
    """FFRNet -> torch.export.ExportedProgram for (b, 112, 112, 3) -> two
    (b, 512), b symbolic from 1 up; symbolic_batch=False exports a fixed
    `static_batch` instead. Raises for a model whose int8 sites are armed
    for calibration (the pass reads each activation's amax on the host)."""
    armed = [name for part in (model.encoder, model.recnet)
             for name, site in quantized_sites(part) if site.calibration is not None]
    if armed:
        raise ValueError(f"export_embed: int8 sites armed for calibration ({armed[:3]}...): "
                         f"export the model that calibrate_int8 returns")
    n = TRACE_BATCH if symbolic_batch else static_batch
    x = torch.zeros((n, 112, 112, 3), dtype=model.dtype, device=model.device)
    shapes = ({0: torch.export.Dim("b", min=1)},) if symbolic_batch else None
    return torch.export.export(EmbedModule(model), (x,), dynamic_shapes=shapes, strict=False)


def input_shape(program) -> list:
    """The program's input shape, a symbolic size as its dimension's name."""
    (name,) = program.graph_signature.user_inputs
    node = next(n for n in program.graph.nodes if n.name == name)
    return ["b" if isinstance(d, torch.SymInt) else int(d) for d in node.meta["val"].shape]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="ffrnet.pt2")
    ap.add_argument("--encoder", default="")
    ap.add_argument("--recnet", default="")
    ap.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--static_batch", type=int, default=0,
                    help="export a fixed batch instead of symbolic 'b'")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu (the twins)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    if args.encoder:
        model = FFRNet.from_pretrained(args.encoder, args.recnet, dtype=dtype, device=dev)
    else:
        print("[export] no weights given: random init", file=sys.stderr)
        model = FFRNet.random(0, dtype=dtype, device=dev)

    program = export_embed(model, symbolic_batch=not args.static_batch,
                           static_batch=args.static_batch or 8)
    torch.export.save(program, args.out)
    tensors = list(program.state_dict.values()) + list(program.constants.values())
    out = {
        "out": args.out,
        "bytes": os.path.getsize(args.out),
        "in_shape": input_shape(program),
        "devices": sorted({str(t.device) for t in tensors if isinstance(t, torch.Tensor)}),
    }

    # round trip: load and compare one call against the live model
    loaded = torch.export.load(args.out).module()
    n = args.static_batch or 4
    x = np.random.default_rng(0).uniform(-1, 1, (n, 112, 112, 3)).astype(np.float32)
    with torch.no_grad():
        got = loaded(torch.from_numpy(x).to(dev, model.dtype))
    want = model.embed(x)
    out["roundtrip_maxerr"] = max(float((a.float() - b.float()).abs().max())
                                  for a, b in zip(got, want))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
