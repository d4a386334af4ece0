"""Serving-layer benchmark: sustained throughput and client latency through
EmbeddingService on the card (ffrnet_tpu/tools/bench_serving.py).

Closed-loop clients submit faces from threads; every client copies its
embeddings to the host (`.cpu()`) before the next submit, so the numbers
include the card's work and the copy back, not a dispatch rate.

Usage:
  python -m ffrnet_torch.tools.bench_serving [--clients 16] [--group 8]
      [--seconds 10] [--max_batch 256] [--dtype fp32|bf16]
      [--encoder bf16|int8|int8_static|int8_all] [--device cuda]
Prints one JSON line. The model is FFRNet.random(0) with its BNs folded;
the int8 arms quantize the encoder (int8: dynamic scales; int8_static:
scales calibrated on 16 faces) or, with int8_all, RecNet's conv chains too
(calibrated), as ffrnet_tpu/tools/bench_serving.py:61-68 does.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--group", type=int, default=8,
                    help="faces per submit (1 = single-face requests)")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--max_batch", type=int, default=256)
    ap.add_argument("--max_delay_ms", type=float, default=2.0)
    ap.add_argument("--buckets", default="",
                    help="comma-separated bucket ladder (default: powers of "
                         "two up to max_batch)")
    ap.add_argument("--dtype", default="bf16", choices=["fp32", "bf16"])
    ap.add_argument("--encoder", default="bf16",
                    choices=["bf16", "int8", "int8_static", "int8_all"],
                    help="encoder arm: int8 = dynamic activation scales, "
                         "int8_static = calibrated static scales "
                         "(FFRNet.calibrate_int8), int8_all = RecNet's conv "
                         "chains int8 too (static scales); bf16 = no int8")
    ap.add_argument("--wire", default="float32", choices=["float32", "uint8"],
                    help="client submission format: uint8 = raw pixels "
                         "(normalized on the card)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ffrnet_torch.api import FFRNet
    from ffrnet_torch.serving import EmbeddingService

    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    q_mode = {"bf16": False, "int8": True, "int8_static": True,
              "int8_all": "all"}[args.encoder]
    model = FFRNet.random(0, device=args.device).prepare(fold_bn=True, dtype=dtype,
                                                         quantize_int8=q_mode)
    if args.encoder in ("int8_static", "int8_all"):
        cal = np.random.default_rng(2).uniform(-1.0, 1.0, (16, 112, 112, 3)).astype(np.float32)
        model = model.calibrate_int8([cal])
    buckets = [int(b) for b in args.buckets.split(",")] if args.buckets else None
    svc = EmbeddingService(model, max_batch=args.max_batch,
                           max_delay_s=args.max_delay_ms / 1e3, buckets=buckets)
    print("[bench_serving] warmup (every bucket once)...", flush=True)
    svc.warmup()

    rng = np.random.default_rng(0)
    if args.wire == "uint8":
        face = rng.integers(0, 256, (args.group, 112, 112, 3), dtype=np.uint8)
    else:
        face = rng.uniform(-1, 1, (args.group, 112, 112, 3)).astype(np.float32)
    stop = time.monotonic() + args.seconds
    lat_lock = threading.Lock()
    latencies: list = []
    served = [0]
    client_errors = [0]

    def client():
        my_lat, my_served, my_err = [], 0, 0
        try:
            while time.monotonic() < stop:
                t0 = time.monotonic()
                raw, _ = svc.submit(face).result(timeout=120)
                with svc.stream_context():
                    raw.cpu()  # the card's work and the copy back are done
                my_lat.append(time.monotonic() - t0)
                my_served += args.group
        except Exception as e:  # noqa: BLE001 — a dead client must not
            # silently shrink the measurement; surface it in the output
            my_err = 1
            print(f"[bench_serving] client error: {e!r}", file=sys.stderr, flush=True)
        finally:
            with lat_lock:
                latencies.extend(my_lat)
                served[0] += my_served
                client_errors[0] += my_err

    threads = [threading.Thread(target=client) for _ in range(args.clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    svc.close()

    lat = np.sort(np.asarray(latencies)) * 1e3
    out = {
        "metric": "served_faces_per_sec",
        "value": round(served[0] / wall, 1),
        "unit": "faces/s",
        "clients": args.clients,
        "group": args.group,
        "requests": len(latencies),
        "latency_ms_p50": round(float(lat[len(lat) // 2]), 1) if len(lat) else None,
        "latency_ms_p99": round(float(lat[int(len(lat) * 0.99)]), 1) if len(lat) else None,
        "client_errors": client_errors[0],
        "dispatches": svc.stats.batches,
        "mean_batch": round(svc.stats.mean_batch, 1),
        "padded_frac": round(svc.stats.padded_faces
                             / max(svc.stats.faces + svc.stats.padded_faces, 1), 3),
        "wire": args.wire,
        "encoder": args.encoder,
        "device": torch.cuda.get_device_name(model.device) if model.device.type == "cuda"
        else "cpu",
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
