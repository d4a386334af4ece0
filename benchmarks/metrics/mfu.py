"""mfu.*: the model operations of a call (`benchmarks/flops.py`, counted
from shapes: an embed's encoder and RecNet, or a train step's frozen
encoder, RecNet forward and backward on both branches and the head) over
the untraced window's wall seconds per call, against the peak of the
configuration's main compute type (`benchmarks/bounds.py::PEAKS`), in %."""

from benchmarks.bounds import PEAKS


def read(run, name):
    ops_per_s = run.info["flops_per_call"] / run.trace.untraced_call_s
    return 100.0 * ops_per_s / PEAKS[run.info["compute"]]
