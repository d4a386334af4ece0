"""conv_ms.*: device ms per call of cuDNN's convolutions (forward, dgrad,
wgrad) and its NCHW<->NHWC layout kernels."""


def read(run, name):
    parts = [run.trace.per_call_ms(g) for g in ("conv (cuDNN)", "layout (NCHW<->NHWC)")]
    parts = [p for p in parts if p is not None]
    return sum(parts) if parts else None
