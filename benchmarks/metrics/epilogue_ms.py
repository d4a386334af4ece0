"""epilogue_ms.*: device ms per call of the elementwise kernel group (BN,
PReLU, residual adds, casts), the quantize and align ranges' kernels left
out."""


def read(run, name):
    return run.trace.per_call_ms("elementwise")
