"""se_gating_roofline: the 24 SE gates' bound at the call's batch and type
(`bounds.se_bound`: maps read and written once, the fp32 pool and mat-vecs)
over their device time per call, in %."""

from benchmarks.bounds import se_bound


def read(run, name):
    t = run.trace.per_call_ms("se_gating")
    if not t:
        return None
    return 100.0 * se_bound(run.info["batch"], run.info["itemsize"])[0] / t
