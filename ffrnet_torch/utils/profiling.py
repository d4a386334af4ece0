"""Profiling hooks (ffrnet_tpu/utils/profiling.py on torch.profiler).

  with maybe_trace(trace_dir):   # traces when a directory is given or
      train_loop()               # FFRNET_TRACE_DIR is set
  with annotate("forward"):      # a named range on the timeline
      ...
  ms = time_op(fn, x, iters=8)   # per-call ms of fn(x), after warm-up

The trace is a Chrome trace (`trace.json`) of the host and, where there is
a card, its kernels, written into the directory when the block ends.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Optional

import torch


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str] = None) -> Iterator[None]:
    trace_dir = trace_dir or os.environ.get("FFRNET_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    with torch.profiler.record_function(name):
        yield


#: calls of `time_op` before its clock starts
WARMUP = 2


def time_op(fn: Callable, x, iters: int = 8, warmup: int = WARMUP) -> float:
    """Milliseconds per call of fn(x) under inference_mode, after `warmup`
    calls. On a CUDA tensor one pair of CUDA events brackets the `iters`
    calls (device time, launches queued back to back); on the CPU the host
    clock does."""
    with torch.inference_mode():
        for _ in range(warmup):
            fn(x)
        if x.device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(x)
            return (time.perf_counter() - t0) / iters * 1e3
        torch.cuda.synchronize(x.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
