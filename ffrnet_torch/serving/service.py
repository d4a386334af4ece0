"""Dynamic micro-batching embedding service on the card.

Counterpart of ffrnet_tpu/serving/service.py. Callers submit single faces
(or small groups) from any number of threads; one collector thread
coalesces them into one `FFRNet.embed` dispatch:

  * **Buckets.** A batch is padded with zero faces up to the next size of
    a fixed ladder (powers of two by default), so the card sees a handful
    of batch shapes and cuDNN a handful of plans.
  * **Micro-batching.** The collector drains the queue up to `max_batch`
    faces, waiting at most `max_delay_s` once the first request of a batch
    has arrived.
  * **Asynchronous results.** Futures resolve with the model's output
    tensors on the model's device as soon as the work is queued on the
    card, so the collector never waits on the card. The collector queues
    on the device's default stream, which is every thread's current
    stream unless that thread set another one: a caller that did must
    wait on the default stream before reading a result (`.cpu()`).
  * **One launching thread.** Every encoder pass, `warmup`'s included,
    runs on the collector thread, so the kernels' launch counters are
    only ever incremented there.

uint8 faces stay uint8 until they are on the card, where they are mapped
to [-1, 1] as (x/255 - 0.5)/0.5 by an IEEE division (`images_to_unit_range`),
the same bits as the JAX package's host normalization.

Usage:
    svc = EmbeddingService(FFRNet.from_pretrained(...), max_batch=256)
    with svc:
        fut = svc.submit(face_112x112x3)       # from any thread
        raw, rect = fut.result()               # tensors on the card
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ffrnet_torch.ops.nn import images_to_unit_range

EMBED_DIM = 512


def _default_buckets(max_batch: int) -> Tuple[int, ...]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


@dataclass
class ServiceStats:
    """Monotonic counters (lock-guarded by the service; read any time)."""
    requests: int = 0
    faces: int = 0
    batches: int = 0
    padded_faces: int = 0   # bucket-padding overhead actually dispatched
    errors: int = 0
    # last 4096 dispatch sizes (bounded: a long-lived service must not grow)
    batch_sizes: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=4096))

    @property
    def mean_batch(self) -> float:
        return self.faces / self.batches if self.batches else 0.0


class _Warmup:
    """A queue item: run one padded bucket through the model."""

    def __init__(self, bucket: int, fut: Future):
        self.bucket, self.fut = bucket, fut


class EmbeddingService:
    """Thread-safe micro-batching front-end over `FFRNet.embed`.

    submit() accepts one face (112, 112, 3) or a group (k, 112, 112, 3):
    uint8 pixels, or floats already in [-1, 1] (BGR, like FFRNet.embed),
    as host arrays. It returns a concurrent.futures.Future resolving to
    (raw_embedding, rectified_embedding) for exactly the submitted faces,
    tensors on the model's device in the model's dtype.
    """

    def __init__(self, model, *, max_batch: int = 256,
                 max_delay_s: float = 0.002,
                 buckets: Optional[Sequence[int]] = None,
                 input_hw: Tuple[int, int] = (112, 112)):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._model = model
        self._max_batch = int(max_batch)
        self._max_delay_s = float(max_delay_s)
        bl = sorted(set(int(b) for b in (buckets or _default_buckets(max_batch))))
        if not bl or bl[-1] < max_batch:
            raise ValueError("largest bucket must cover max_batch")
        if any(b < 1 for b in bl):
            raise ValueError("buckets must be positive")
        self._buckets = tuple(bl)
        self._input_hw = tuple(input_hw)
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        # guards the closed-check+enqueue pair in submit() against close()
        # (a request must not land behind the shutdown token) and every
        # stats mutation (counters touched from client + worker threads)
        self._lock = threading.Lock()
        self.stats = ServiceStats()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="ffrnet-embed-service")
        self._worker.start()

    # ------------------------------------------------------------------ API
    @property
    def max_batch(self) -> int:
        """Largest group accepted by a single submit()."""
        return self._max_batch

    @property
    def device(self) -> torch.device:
        return torch.device(self._model.device)

    def stream_context(self):
        """The context in which results are ready to read: the device's
        default stream on a card (the stream the collector queues on), a
        no-op on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.stream(torch.cuda.default_stream(self.device))
        return contextlib.nullcontext()

    def submit(self, faces) -> Future:
        """Enqueue one face or one (k, H, W, 3) group; returns a Future.

        The input is COPIED: a caller reusing its buffer before the
        collector dispatches must not corrupt the co-batched group. uint8
        stays uint8 (normalized on the device), anything else becomes
        float32."""
        peek = np.asarray(faces)
        dtype = np.uint8 if peek.dtype == np.uint8 else np.float32
        arr = np.array(peek, dtype=dtype, copy=True)
        if arr.ndim == 3:
            arr = arr[None]
        h, w = self._input_hw
        if arr.ndim != 4 or arr.shape[1:] != (h, w, 3):
            raise ValueError(
                f"expected ({h}, {w}, 3) face(s), got {arr.shape}")
        if arr.shape[0] > self._max_batch:
            raise ValueError(
                f"group of {arr.shape[0]} exceeds max_batch={self._max_batch};"
                " split it or raise max_batch")
        fut: Future = Future()
        if arr.shape[0] == 0:
            # resolved at once: an empty group reaching the collector would
            # dispatch a fully padded bucket to compute nothing
            empty = torch.zeros((0, EMBED_DIM), dtype=torch.float32, device=self.device)
            fut.set_result((empty, empty))
            return fut
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            self._queue.put((arr, fut))
            self.stats.requests += 1
        return fut

    def warmup(self) -> None:
        """Run every bucket once on the collector thread: the kernels are
        built at first use and cuDNN makes its first plan choice for each
        batch shape. Blocks until all buckets have run on the device, and
        raises what a bucket raised (a kernel that fails to build or
        launch)."""
        futs = []
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            for b in self._buckets:
                futs.append(Future())
                self._queue.put(_Warmup(b, futs[-1]))
        for fut in futs:
            raw, _ = fut.result()
            with self.stream_context():
                raw.cpu()  # waits for the device

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Stop accepting work, drain the queue, join the worker."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # wake the collector; FIFO guarantees
            # every already-accepted request is drained first
        self._worker.join(timeout=timeout)

    def __enter__(self) -> "EmbeddingService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ collector
    def _take_batch(self):
        """Block for the first request, then drain until max_batch faces or
        max_delay_s has elapsed. Returns a list of (array, future), a
        _Warmup alone, or None on a shutdown wake."""
        first = self._queue.get()
        if first is None or isinstance(first, _Warmup):
            return first
        batch = [first]
        total = first[0].shape[0]
        deadline = time.monotonic() + self._max_delay_s
        while total < self._max_batch:
            remaining = deadline - time.monotonic()
            try:
                item = self._queue.get(
                    timeout=max(remaining, 0.0) if remaining > 0 else None,
                    block=remaining > 0)
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # re-arm shutdown for the outer loop
                break
            if isinstance(item, _Warmup) or total + item[0].shape[0] > self._max_batch:
                # a warmup runs alone, and an overflowing group waits for
                # the next batch (queue order shifts; per-request results
                # are independent so correctness is unaffected)
                self._queue.put(item)
                break
            batch.append(item)
            total += item[0].shape[0]
        return batch

    def _run(self) -> None:
        with self.stream_context():
            while True:
                batch = self._take_batch()
                if batch is None:
                    if self._closed and self._queue.empty():
                        return
                    if self._closed:
                        # a submit raced close(): keep the shutdown token
                        # queued behind the remaining work
                        self._queue.put(None)
                    continue
                if isinstance(batch, _Warmup):
                    self._warm(batch)
                else:
                    self._dispatch(batch)

    def _warm(self, item: _Warmup) -> None:
        if not item.fut.set_running_or_notify_cancel():
            return
        h, w = self._input_hw
        try:
            out = self._model.embed(torch.zeros((item.bucket, h, w, 3), device=self.device))
        except Exception as e:  # noqa: BLE001 — raised to warmup()'s caller
            item.fut.set_exception(e)
        else:
            item.fut.set_result(out)

    def _dispatch(self, batch) -> None:
        # claim every future before dispatching: a future in RUNNING state
        # cannot be cancel()ed, so set_result/set_exception below cannot
        # race a caller's cancel into InvalidStateError
        live = [(a, fut) for a, fut in batch if fut.set_running_or_notify_cancel()]
        if not live:
            return
        # uint8 groups first: each dtype crosses to the card as one block
        live.sort(key=lambda r: r[0].dtype != np.uint8)
        total = sum(a.shape[0] for a, _ in live)
        try:
            bucket = next(b for b in self._buckets if b >= total)
            raw, rect = self._model.embed(self._assemble([a for a, _ in live], bucket))
        except Exception as e:  # noqa: BLE001 — propagate to callers;
            # the collector thread must survive any batch failure
            with self._lock:
                self.stats.errors += len(live)
            for _, fut in live:
                fut.set_exception(e)
            return
        with self._lock:
            self.stats.batches += 1
            self.stats.faces += total
            self.stats.padded_faces += bucket - total
            self.stats.batch_sizes.append(total)
        off = 0
        for a, fut in live:
            k = a.shape[0]
            fut.set_result((raw[off:off + k], rect[off:off + k]))
            off += k

    def _assemble(self, arrs, bucket: int) -> torch.Tensor:
        """(bucket, H, W, 3) float32 on the device: the groups' faces in
        [-1, 1] in order (uint8 ones first), zero faces after them. Each
        dtype's faces are packed into one pinned host block and copied
        without blocking; the pinned allocator keeps a block from reuse
        until its copy has run."""
        dev = self.device
        h, w = self._input_hw
        x = torch.empty((bucket, h, w, 3), dtype=torch.float32, device=dev)
        off = 0
        for dtype, tdtype in ((np.uint8, torch.uint8), (np.float32, torch.float32)):
            part = [a for a in arrs if a.dtype == dtype]
            if not part:
                continue
            n = sum(a.shape[0] for a in part)
            host = torch.empty((n, h, w, 3), dtype=tdtype, pin_memory=dev.type == "cuda")
            np.concatenate(part, axis=0, out=host.numpy())
            x[off:off + n] = images_to_unit_range(host.to(dev, non_blocking=True))
            off += n
        x[off:].zero_()
        return x
