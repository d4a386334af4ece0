"""int8_conv_roofline: the bound of one int8 IR-SE50 forward's 52 int8_conv
calls at the call's batch (`bounds.int8_bound` over `int8_site_calls`)
over their device time per call, in %."""

from benchmarks.bounds import int8_bound, int8_site_calls


def read(run, name):
    t = run.trace.per_call_ms("int8_conv")
    if not t:
        return None
    calls = int8_site_calls(run.info["batch"], run.info["itemsize"])
    return 100.0 * int8_bound(calls)[0] / t
