"""batch_ms_p95: the 95th percentile of every call's latency in the window,
from the call to its embeddings on the host, in ms (host clock)."""

from benchmarks.harness import p95


def read(run, name):
    return p95(run.window.latencies_s) * 1e3
