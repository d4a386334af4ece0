"""Minimal HTTP front for EmbeddingService (stdlib only).

Counterpart of ffrnet_tpu/serving/http.py, with the same endpoints, wire
format, status codes and hardening. A threaded `http.server`: each HTTP
worker thread blocks on its request's Future while the collector
coalesces across connections. The wire format is raw little-endian bytes.

Endpoints:
  POST /embed     body = float32 LE bytes of (N, 112, 112, 3) in [-1,1] BGR
                  (N inferred from content length)
                  -> 200, body = float32 LE bytes of (2, N, 512):
                     [raw_embedding, rectified_embedding]
                  All face-body endpoints also accept raw uint8 pixels
                  (0..255 BGR, 4x smaller requests) with header
                  X-Input-Dtype: uint8; the service maps them to [-1, 1]
                  on the card as (x/255 - 0.5)/0.5.
  POST /verify    body = 2*N faces — first N = img1, last N = img2 ->
                  float32 LE bytes of (N,) cosine scores (rectified)
  POST /enroll    1:N gallery enrollment. Labels via ONE of:
                    X-Labels:      comma-separated N labels (no ',' in a
                                   label, Latin-1 only); or
                    X-Labels-Json: JSON array of N strings, ASCII-encoded
                  body = N faces -> JSON {"enrolled": N, "gallery_size": G}
  POST /identify  Header X-Top-K (default 1); body = P faces -> JSON
                  {"labels": [[...k per probe]], "scores": [[...]]}
  GET  /healthz   -> 200 "ok" once the service is up
  GET  /stats     -> 200 JSON ServiceStats snapshot

Status codes: 400 on a bad X-Input-Dtype, a malformed or missing
(chunked) Content-Length, or a body that is not a whole number of faces
(the declared body is drained first); 413 before reading a body above
`max_request_faces` faces; 409 on /identify with an empty gallery or k
above its size; 500 with the error's repr on any other failure.
Embeddings cross the wire as float32, whatever the model's dtype.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np
import torch

from ffrnet_torch.eval.search import Gallery, top_k_identify

FACE_SHAPE = (112, 112, 3)
_FACE_PIXELS = int(np.prod(FACE_SHAPE))
_FACE_BYTES = _FACE_PIXELS * 4


class EmbeddingHTTPServer:
    """Serve an EmbeddingService over HTTP. Start with .start(); stop with
    .close(). `addr` is (host, port); port 0 picks a free port (see
    .port after start)."""

    def __init__(self, service, addr: Tuple[str, int] = ("127.0.0.1", 0),
                 gallery=None, max_request_faces: int = 4096):
        self._service = service
        self._max_request_faces = int(max_request_faces)
        # 1:N gallery for /enroll + /identify: embeddings on the service's
        # device at power-of-two capacity, labels on the host; guarded —
        # enrolls race identifies
        self._gallery_lock = threading.Lock()
        self._gallery_emb = None      # (cap, 512) float32 tensor or None
        self._gallery_labels: list = []
        if gallery is not None:       # warm start from eval.search.Gallery
            self._enroll(gallery.embeddings, list(gallery.labels))
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet: stats live at /stats
                pass

            def _reply(self, code: int, body: bytes,
                       ctype: str = "application/octet-stream"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, b"ok", "text/plain")
                elif self.path == "/stats":
                    s = outer._service.stats
                    self._reply(200, json.dumps({
                        "requests": s.requests, "faces": s.faces,
                        "batches": s.batches, "errors": s.errors,
                        "padded_faces": s.padded_faces,
                        "mean_batch": s.mean_batch,
                    }).encode(), "application/json")
                else:
                    self._reply(404, b"not found", "text/plain")

            def _read_faces(self) -> Optional[np.ndarray]:
                dtype = self.headers.get("X-Input-Dtype", "float32").lower()
                if dtype not in ("float32", "uint8"):
                    self.close_connection = True
                    self._reply(400, b"X-Input-Dtype must be float32 or "
                                b"uint8", "text/plain")
                    return None
                face_bytes = _FACE_PIXELS if dtype == "uint8" else _FACE_BYTES
                try:
                    n_bytes = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    # answer 400 rather than let the ValueError drop the
                    # connection with no HTTP reply
                    self.close_connection = True
                    self._reply(400, b"malformed Content-Length",
                                "text/plain")
                    return None
                limit = outer._max_request_faces * face_bytes
                if n_bytes > limit:
                    # refuse BEFORE reading: draining a multi-GB body would
                    # be the memory exhaustion this cap exists to prevent
                    self.close_connection = True
                    self._reply(
                        413,
                        f"body exceeds max_request_faces="
                        f"{outer._max_request_faces} faces "
                        f"({limit} bytes)".encode(), "text/plain")
                    return None
                if n_bytes <= 0 or n_bytes % face_bytes:
                    if n_bytes <= 0:
                        # no declared length (e.g. Transfer-Encoding:
                        # chunked): the body cannot be drained, so the
                        # connection must close or its unread bytes desync
                        # every pipelined request on this socket
                        self.close_connection = True
                    # drain the declared body first: leaving it unread would
                    # desync the next request on a keep-alive connection
                    remaining = n_bytes
                    while remaining > 0:
                        chunk = self.rfile.read(min(remaining, 1 << 20))
                        if not chunk:
                            break
                        remaining -= len(chunk)
                    self._reply(400, b"body must be %s LE (N,112,112,3)"
                                % dtype.encode(), "text/plain")
                    return None
                raw = self.rfile.read(n_bytes)
                n = n_bytes // face_bytes
                return np.frombuffer(raw, np.uint8 if dtype == "uint8" else "<f4").reshape(
                    (n,) + FACE_SHAPE)

            def _embed_chunked(self, faces):
                """submit() in max_batch chunks, so a large POST (a bulk
                /enroll) is served instead of refused; -> (raw, rect) as
                float32 numpy arrays."""
                svc = outer._service
                mb = svc.max_batch
                futs = [svc.submit(faces[i:i + mb])
                        for i in range(0, faces.shape[0], mb)]
                raws, rects = [], []
                for f in futs:
                    raw, rect = f.result()
                    with svc.stream_context():
                        raws.append(raw.float().cpu().numpy())
                        rects.append(rect.float().cpu().numpy())
                return np.concatenate(raws), np.concatenate(rects)

            def do_POST(self):
                faces = self._read_faces()
                if faces is None:
                    return
                try:
                    if self.path == "/embed":
                        raw, rect = self._embed_chunked(faces)
                        self._reply(200, np.stack([raw, rect]).astype(
                            "<f4", copy=False).tobytes())
                    elif self.path == "/verify":
                        n = faces.shape[0]
                        if n % 2:
                            self._reply(400, b"verify needs an even count",
                                        "text/plain")
                            return
                        _, rect = self._embed_chunked(faces)
                        a, b = rect[: n // 2], rect[n // 2:]
                        # the epsilon of eval.lfw.pair_cosine: a zero-norm
                        # embedding scores 0.0, never NaN
                        scores = np.sum(a * b, axis=1) / (
                            np.linalg.norm(a, axis=1)
                            * np.linalg.norm(b, axis=1) + 1e-8)
                        self._reply(200, scores.astype(
                            "<f4", copy=False).tobytes())
                    elif self.path == "/enroll":
                        labels_json = self.headers.get("X-Labels-Json")
                        if labels_json is not None:
                            try:
                                labels = json.loads(labels_json)
                            except ValueError:
                                labels = None
                            if not (isinstance(labels, list) and all(
                                    isinstance(s, str) for s in labels)):
                                self._reply(
                                    400, b"X-Labels-Json must be a JSON "
                                    b"array of strings", "text/plain")
                                return
                        else:
                            labels = [s for s in
                                      self.headers.get("X-Labels",
                                                       "").split(",")
                                      if s]
                        if len(labels) != faces.shape[0]:
                            self._reply(
                                400, b"label count != face count (labels "
                                b"with ',' need X-Labels-Json)", "text/plain")
                            return
                        _, rect = self._embed_chunked(faces)
                        g = outer._enroll(rect, labels)
                        self._reply(200, json.dumps(
                            {"enrolled": len(labels),
                             "gallery_size": g}).encode(),
                            "application/json")
                    elif self.path == "/identify":
                        try:
                            k = int(self.headers.get("X-Top-K", "1"))
                        except ValueError:
                            self._reply(400, b"X-Top-K must be an integer",
                                        "text/plain")
                            return
                        _, rect = self._embed_chunked(faces)
                        res = outer._identify(rect, k)
                        if res is None:
                            self._reply(409, b"gallery is empty or k too "
                                        b"large; POST /enroll first",
                                        "text/plain")
                            return
                        self._reply(200, json.dumps(res).encode(),
                                    "application/json")
                    else:
                        self._reply(404, b"not found", "text/plain")
                except Exception as e:  # noqa: BLE001 — HTTP error, not a crash
                    self._reply(500, repr(e).encode(), "text/plain")

        self._httpd = ThreadingHTTPServer(addr, Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="ffrnet-http-server")

    # --------------------------------------------------------- 1:N gallery
    # Capacity grows by doubling; rows at and past the live count are
    # masked at search time (`valid`). An enroll writes its rows in place
    # and a growth makes a new tensor, so rows a search can see are never
    # written again. The gallery is an ordinary tensor (not an inference
    # tensor), made and written outside inference mode: the in-place row
    # copies would refuse an inference tensor.
    @torch.inference_mode(False)
    def _enroll(self, rect_emb, labels) -> int:
        emb = torch.as_tensor(rect_emb).to(self._service.device, torch.float32)
        with self._gallery_lock, self._service.stream_context():
            off = len(self._gallery_labels)
            n_new = off + emb.shape[0]
            cap = max(8, 1 << (n_new - 1).bit_length())
            g = self._gallery_emb
            if g is None:
                g = torch.zeros((cap, emb.shape[1]), dtype=torch.float32, device=emb.device)
            elif g.shape[0] < cap:
                g = torch.cat([g, g.new_zeros((cap - g.shape[0], g.shape[1]))])
            g[off:n_new].copy_(emb)
            self._gallery_emb = g
            self._gallery_labels.extend(labels)
            return n_new

    def gallery(self) -> Gallery:
        """Snapshot the live rows as an eval.search.Gallery (persist with
        its .save(); warm-start a new server via the `gallery=` argument)."""
        with self._gallery_lock:
            if self._gallery_emb is None:
                return Gallery(torch.zeros((0, 512), dtype=torch.float32,
                                           device=self._service.device), [])
            n = len(self._gallery_labels)
            return Gallery(self._gallery_emb[:n].clone(), list(self._gallery_labels))

    def _identify(self, rect_emb, k: int):
        with self._gallery_lock:
            gal = self._gallery_emb
            labels = list(self._gallery_labels)
        if gal is None or k < 1 or k > len(labels):
            return None
        with self._service.stream_context():
            rect = torch.as_tensor(rect_emb).to(gal.device)
            scores, idx = top_k_identify(rect, gal, k=k, valid=len(labels))
            scores, idx = scores.cpu().numpy(), idx.cpu().tolist()
        return {"labels": [[labels[j] for j in row] for row in idx],
                "scores": scores.astype(np.float32).round(6).tolist()}

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "EmbeddingHTTPServer":
        self._thread.start()
        return self

    def close(self) -> None:
        # shutdown() waits on an event only serve_forever() sets: called
        # when start() never ran it would wait forever; a started-then-
        # exited thread has set it, so shutdown() returns at once there
        if self._thread.is_alive():
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=10)

    def __enter__(self) -> "EmbeddingHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
