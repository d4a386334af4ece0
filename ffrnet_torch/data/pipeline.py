"""Host batch pipeline: threaded decode, a bounded prefetch queue, and the
upload to the card in the producer thread (ffrnet_tpu/data/pipeline.py).

  * `batch_size` is the global batch; process `process_index` of
    `process_count` decodes its strided share of the epoch's shuffled index
    stream, each share truncated to the same length so every process takes
    the same number of steps
  * a thread pool decodes the samples of a batch concurrently
  * the producer thread uploads each assembled batch (`device=`): from
    pinned memory with non_blocking=True on a CUDA stream of the loader's
    own, so batch k+1 crosses while step k runs; the consumer's stream
    waits for that copy before it touches the tensors

Seeding: one numpy Generator per (seed, epoch, sample), so augmentation is
reproducible, independent of thread timing, and the same as the JAX
package's loader: for the same dataset and seed the two give bit-equal
batches.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch


class SliceDataset:
    """A contiguous [start, stop) view of a dataset (the same .get). The
    verification folds are contiguous index ranges, so a process that
    scores part of a pair list owns a contiguous block
    (eval.runner.process_pair_slice)."""

    def __init__(self, dataset, sl: slice):
        start, stop, step = sl.indices(len(dataset))
        if step != 1:
            raise ValueError("SliceDataset needs a contiguous slice")
        self.dataset = dataset
        self.start, self.stop = start, stop

    def __len__(self):
        return self.stop - self.start

    def get(self, idx, rng):
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        return self.dataset.get(self.start + idx, rng)


def _stack(values, axis=0):
    if isinstance(values[0], torch.Tensor):
        return torch.stack(values, dim=axis)
    return np.stack(values, axis=axis)


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))


class BatchLoader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 123, num_threads: int = 4,
                 prefetch: int = 2, process_index: int = 0, process_count: int = 1,
                 device=None, pack: Optional[Dict[str, tuple]] = None):
        """device: None gives host numpy batches; else each batch is a dict
        of tensors on that device. pack: {"out_key": ("key_a", "key_b")}
        stacks those sample keys on a new axis 1 into one array per batch
        (one upload in place of two)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.device = None if device is None else torch.device(device)
        self.pack = dict(pack) if pack else None
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} out of range for "
                             f"process_count {process_count}")
        if batch_size % process_count:
            raise ValueError(f"global batch_size {batch_size} must divide evenly over "
                             f"{process_count} processes")
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch = batch_size // process_count
        self.shard_len = len(dataset) // process_count

    def __len__(self):
        if self.drop_last:
            return self.shard_len // self.local_batch
        return -(-self.shard_len // self.local_batch)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        return idx[self.process_index::self.process_count][:self.shard_len]

    def _assemble(self, samples) -> Dict[str, Any]:
        batch = {k: _stack([s[k] for s in samples]) for k in samples[0].keys()}
        if self.pack:
            for out_key, src_keys in self.pack.items():
                batch[out_key] = _stack([batch.pop(k) for k in src_keys], axis=1)
        return batch

    def _upload(self, batch, stream):
        """The batch on self.device, and the CUDA event that marks the end
        of its copy (None off the card)."""
        if self.device is None:
            return batch, None
        if stream is None:
            return {k: _tensor(v).to(self.device) for k, v in batch.items()}, None
        with torch.cuda.stream(stream):
            # the pinned staging buffers go back to PyTorch's host allocator,
            # which reuses one only after the copy that reads it has ended
            out = {k: _tensor(v).pin_memory().to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def epoch(self, epoch: int = 0, start_batch: int = 0) -> Iterator[Dict[str, Any]]:
        """The batches of one epoch. start_batch skips the first batches
        without decoding or uploading them (the resume fast-forward); the
        per-sample RNG keeps every later batch bit-equal to a full epoch's."""
        indices = self._epoch_indices(epoch)
        n_batches = len(self)
        if not 0 <= start_batch <= n_batches:
            raise ValueError(f"start_batch {start_batch} out of range [0, {n_batches}]")
        on_card = self.device is not None and self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if on_card else None

        pool = ThreadPoolExecutor(max_workers=self.num_threads)

        def load_one(i):
            rng = np.random.default_rng((self.seed, epoch, int(i)))
            return self.dataset.get(int(i), rng)

        def make_batch(b):
            sl = indices[b * self.local_batch:(b + 1) * self.local_batch]
            return self._assemble(list(pool.map(load_one, sl)))

        out_q: "queue.Queue" = queue.Queue(maxsize=max(self.prefetch, 1))
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # a consumer that abandons the generator sets `stop`; never block
            # past it, or the thread leaks
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(start_batch, n_batches):
                    if not put_or_stop(self._upload(make_batch(b), stream)):
                        return
                put_or_stop(None)
            except BaseException as e:  # noqa: BLE001 — handed to the consumer, which raises it
                put_or_stop(e)
            finally:
                pool.shutdown(wait=False)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, done = item
                if done is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(done)
                    for v in batch.values():
                        v.record_stream(current)  # freed only after the consumer's work
                yield batch
        finally:
            stop.set()
            try:  # wake a producer blocked in put()
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass

    def __iter__(self):
        return self.epoch(0)
