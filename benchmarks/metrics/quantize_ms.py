"""quantize_ms: device ms per call of the kernels that quantize the int8
sites' activations (`ops/quant.py`'s quantize_activation and to_nhwc, under
the range a traced run opens around them)."""


def read(run, name):
    return run.trace.per_call_ms("int8 quantize")
