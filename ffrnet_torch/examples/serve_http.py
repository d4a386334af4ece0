"""Serving on the card: model -> micro-batching service -> HTTP
(examples/serve_http.py).

    python -m ffrnet_torch.examples.serve_http [port] [--device cuda]

Client side (any language): POST float32 LE bytes of (N, 112, 112, 3)
faces in [-1, 1] BGR to /embed; read (2, N, 512) float32 back. See
ffrnet_torch/serving/http.py for the full wire format.
"""

import argparse
import time


def main(argv=None):
    from ffrnet_torch.api import FFRNet
    from ffrnet_torch.serving import EmbeddingHTTPServer, EmbeddingService

    ap = argparse.ArgumentParser()
    ap.add_argument("port", nargs="?", type=int, default=8571)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    model = FFRNet.random(0, device=args.device)
    svc = EmbeddingService(model, max_batch=256, max_delay_s=0.002)
    print("running every bucket once...")
    svc.warmup()
    with EmbeddingHTTPServer(svc, ("0.0.0.0", args.port)) as srv:
        print(f"serving on :{srv.port}  (GET /healthz, /stats; "
              f"POST /embed, /verify, /enroll, /identify). Ctrl-C to stop.")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
    svc.close()
    s = svc.stats
    print(f"served {s.faces} faces in {s.batches} dispatches "
          f"(mean batch {s.mean_batch:.1f})")


if __name__ == "__main__":
    main()
