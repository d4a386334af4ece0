"""Profiling hooks (ffrnet_tpu/utils/profiling.py on torch.profiler).

  with maybe_trace(trace_dir):   # traces when a directory is given or
      train_loop()               # FFRNET_TRACE_DIR is set
  with annotate("forward"):      # a named range on the timeline
      ...

The trace is a Chrome trace (`trace.json`) of the host and, where there is
a card, its kernels, written into the directory when the block ends.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

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
