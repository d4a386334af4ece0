"""channel_branch_roofline: the channel branch's bound at the call's batch
and type (`bounds.cb_bound`) over its device time per call, in %."""

from benchmarks.bounds import cb_bound


def read(run, name):
    t = run.trace.per_call_ms("channel_branch")
    if not t:
        return None
    return 100.0 * cb_bound(run.info["batch"], run.info["itemsize"])[0] / t
