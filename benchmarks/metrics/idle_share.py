"""idle_share.*: the share of the time in which no operation ran on the
device (kernels, copies and sets, their intervals' union), in %: the
device-only traced window's busy seconds per call over the untraced
window's wall seconds per call (`trace.TraceData.busy_share`)."""


def read(run, name):
    return 100.0 * (1.0 - run.trace.busy_share())
